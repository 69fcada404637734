"""The training cell's per-layer readers, one function per quantity; each
``metrics/<name>.train.py`` calls one of them."""

from benchmark.counts import k3, train_step
from benchmark.harness import peaks
from benchmark.harness.readers import idle, mfu, roofline, training_work

# K3's kernels by wrapper (ops/csrc/cond_ctx.cu): forward, backward A, B
K3_KERNELS = ("ln_rows", "ctx_fwd_kv", "ctx_fwd_merge",
              "ctx_bwd_kv", "ctx_bwd_dx", "ln_backward", "sum_partials",
              "ctx_bwd_w", "sum_splits")


def k3_roofline(run):
    w = training_work(run)
    if w is None:
        return None
    calls = [fb + (peaks.BF16_FLOPS,) for _ in range(w["steps"])
             for fb in k3.step(run.cell.config, w["batch"])]
    return roofline(run, K3_KERNELS, calls)


def training_mfu(run):
    w = training_work(run)
    if w is None:
        return None
    return mfu(run, train_step.sample(run.cell.config))


def training_idle(run):
    return idle(run) if training_work(run) is not None else None


def step_enqueue_ms(run):
    """Host ms a step spends in the step's call, which returns without
    waiting for the card: the mean over the traced window's calls."""
    w = training_work(run)
    if w is None:
        return None
    reqs = run.traced["requests"]
    return 1e3 * sum(r.done - r.sent for r in reqs) / w["steps"]
