"""Data-parallel training and inference in the port over ``torch.distributed``
(``raggesture_tpu_torch/parallel/mesh.py``), on the CPU: two gloo
processes on a free localhost port, against one process on the stitched
global batch, and against the JAX package where it has a counterpart
(the synced ``LossSecondMomentResampler``, the result blobs).

Groups of two processes run once for the module: the training tool with
``--distributed`` (2 epochs of the tiny config, then resumed to a third),
and a worker that runs the collectives' cases on inputs this process
wrote.  Tolerances: the first step's per-sample losses bitwise (each
rank's rows take the whole batch's float32 operations on the CPU); later
losses 1e-5 relative (1e-4 after the resume); losses summed over the ranks
1e-6 relative and gradients 1e-6 of the largest (the cases use
true-separator query masks: the reference's quirk rows carry -1e6 into a
LayerNorm); the parameters as ``test_two_rank_tool_run_...`` states.
"""

import inspect
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_common import port_arch_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "configs/raggesture_beatx/tiny_smoke.py")
WORLD = 2


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                MKL_NUM_THREADS="1")


def _launch(cmds, cwd, timeout=240):
    """Run one process per rank, together; raise with their output when
    one fails."""
    procs = [subprocess.Popen(c, cwd=cwd, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def _cfg():
    from raggesture_tpu.datasets.fixtures import tiny_arch_config

    return port_arch_config(tiny_arch_config())


def _model(cfg=None, seed=1):
    from raggesture_tpu_torch.models.architecture import create_model

    return create_model(cfg or _cfg(), device="cpu", seed=seed,
                        zero_init_std=0.05)


# ------------------------------------------------------- the worker's cases

WORKER = r'''
import sys, torch
torch.set_num_threads(1)
from raggesture_tpu_torch.parallel import mesh
rank = int(sys.argv[2])
mesh.init_distributed(sys.argv[1], 2, rank, device="cpu")
inp = torch.load(sys.argv[3], weights_only=False)
out = {}
from raggesture_tpu_torch.models.architecture import (
    MotionDiffusionModel, StagedGenerator, training_loss)
from raggesture_tpu_torch.train.loop import make_train_step

def model_of(cfg):
    m = MotionDiffusionModel(cfg).eval()
    m.load_state_dict(inp["state"])
    return m

cfg = inp["cfg"]
model = model_of(cfg)
sched = cfg.diffusion_train.schedule(device="cpu")
mine = mesh.shard_batch(inp["batch"])
B = len(mine["motion_mask"])
shard = mesh.local_shard(B)

def grads_of(m, loss):
    m.zero_grad(set_to_none=True)
    loss.backward()
    ps = [p for p in m.denoiser.parameters() if p.grad is not None]
    n = mesh.all_reduce_grads_(ps)
    return {k: p.grad.clone() for k, p in m.denoiser.named_parameters()}, n

# the loss over ranks whose token-mask sums differ, explicit draws
draws = mesh.shard_batch(inp["draws"])
qm = mesh.shard_batch(inp["query_masks"])
loss, logs = training_loss(model, sched, mine, shard=shard, query_masks=qm,
                           **draws)
out["explicit_loss"] = mesh.all_reduce_sum(loss.detach())
out["explicit_grads"], out["reduced_elements"] = grads_of(model, loss)
local, _ = training_loss(model, sched, mine, query_masks=qm, **draws)
out["local_loss"] = local.detach()
out["token_mask_sum"] = logs["mse_unweighted"].new_tensor(
    float(mine["motion_mask"].sum()))
# with importance weights: the mean over the global batch
loss_w, _ = training_loss(model, sched, mine, shard=shard, query_masks=qm,
                          t_weights=mesh.shard_batch(inp["t_weights"]),
                          **draws)
out["weighted_loss"] = mesh.all_reduce_sum(loss_w.detach())
# every draw from the generator: the global batch's, this rank's rows
g = torch.Generator().manual_seed(5)
loss_g, _ = training_loss(model, sched, mine, g, shard=shard,
                          query_masks=qm)
out["drawn_loss"] = mesh.all_reduce_sum(loss_g.detach())
out["drawn_grads"], _ = grads_of(model, loss_g)
# the per-layer forward with dropout, masks drawn for the global batch
dmodel = model_of(inp["cfg_dropout"])
g = torch.Generator().manual_seed(6)
loss_d, _ = training_loss(dmodel, sched, mine, g, shard=shard,
                          query_masks=qm, fused_ctx=False)
out["dropout_loss"] = mesh.all_reduce_sum(loss_d.detach())
out["dropout_grads"], _ = grads_of(dmodel, loss_d)

# the synced loss-second-moment sampler, ragged shards
from raggesture_tpu_torch.diffusion.samplers import LossSecondMomentResampler
rs = LossSecondMomentResampler(inp["rs_T"], history_per_term=2)
for ts, ls in inp["rs_rounds"][rank]:
    rs.update_with_losses(ts, ls)
out["rs_history"] = rs._loss_history.copy()
out["rs_counts"] = rs._loss_counts.copy()
out["rs_weights"] = rs.weights()

# multi_device_test over each rank's loader shard
from raggesture_tpu_torch.train.inference import multi_device_test
loader = inp["loaders"][rank]
out["gathered"] = multi_device_test(
    lambda b: {"x": torch.as_tensor(b["x"]) * 2}, loader)

# the sharded samplers
gen = StagedGenerator(model, cfg.diffusion_test.schedule(device="cpu"),
                      fused=False)
sb = inp["sample"]
out["sharded"] = mesh.sharded_sampler(gen)(
    sb["batch"], sb["noise"], sb["coef_table"], sb["query_masks"])
out["sharded_guided"] = mesh.sharded_guided_sampler(gen)(
    sb["batch"], sb["noise"], sb["inv_all"], sb["in_seq_noise"],
    sb["coef_table"], sb["query_masks"])

# replicate_tree: rank 1 starts from other values
state = {k: v.clone() for k, v in inp["state"].items()
         if k.startswith("denoiser.")}
if rank == 1:
    for v in state.values():
        v.add_(1.0)
out["replicated_same"] = mesh.replicate_tree(state)
out["replicated"] = state
torch.save(out, sys.argv[4])
mesh.shutdown()
'''


def _dist_batch(seed=0, B=4, frames=30):
    """A global batch of ``B`` windows whose second half is padded: rank 1's
    token-mask sum is smaller than rank 0's."""
    from raggesture_tpu.datasets.fixtures import tiny_batch

    b = {k: torch.as_tensor(np.array(v)) for k, v in
         tiny_batch(seed=seed, batch=B, frames=frames).items()}
    b = {k: (v.long() if k == "speaker_ids" else v.float())
         for k, v in b.items()}
    mm = torch.ones(B, frames)
    mm[B // 2:, frames // 2:] = 0.0
    mm[B - 1, 5:] = 0.0
    b["motion_mask"] = mm
    return b


@pytest.fixture(scope="module")
def worker(tmp_path_factory):
    """The worker's two ranks on the module's inputs: (inputs, [rank 0's
    outputs, rank 1's])."""
    import dataclasses

    from raggesture_tpu_torch.models.architecture import StagedGenerator
    from raggesture_tpu_torch.models.codec import PART_NAMES

    tmp = tmp_path_factory.mktemp("worker")
    cfg = _cfg()
    model = _model(cfg)
    B = 4
    batch = _dist_batch(B=B)
    g = torch.Generator().manual_seed(2)
    dc = cfg.denoiser
    draws = {"t": torch.randint(0, 100, (B,), generator=g),
             "noise": torch.randn(B, dc.num_tokens, dc.latent_dim,
                                  generator=g),
             "cond_mask": torch.ones(B, 1, 1),
             "enc_eps": {p: torch.randn(B, 2, cfg.codec.latent_dim,
                                        generator=g) for p in PART_NAMES}}
    rng = np.random.RandomState(4)
    rounds = [[(rng.randint(0, 6, n), rng.rand(n)) for n in sizes]
              for sizes in ((3, 1, 4, 2, 6, 5), (5, 2, 0, 6, 3, 4))]
    loaders = [[{"sample_name": [f"r{r}b{i}s{j}" for j in range(2)],
                 "x": np.arange(2, dtype=np.float32) + 10 * r + i,
                 "valid_mask": np.array([True, i == 0 or r == 0])}
                for i in range(2)] for r in range(WORLD)]
    gen = StagedGenerator(model, cfg.diffusion_test.schedule(device="cpu"),
                          fused=False)
    S = gen.sched.num_timesteps
    gs = torch.Generator().manual_seed(9)
    inv_all = torch.randn(S, B, dc.num_tokens, dc.latent_dim, generator=gs)
    inv_all[:, :, 3:] = 0.0
    sample = {"batch": {k: batch[k] for k in ("word", "audio", "speaker_ids",
                                               "motion_mask")},
              "noise": torch.randn(B, dc.num_tokens, dc.latent_dim,
                                   generator=gs),
              "coef_table": torch.rand(S, 4, generator=gs),
              "query_masks": {k: torch.ones(B, dc.num_tokens)
                              for k in ("xf_text", "xf_audio", "xf_spk")},
              "inv_all": inv_all,
              "in_seq_noise": torch.randn(S, B, dc.num_tokens,
                                          dc.latent_dim, generator=gs)}
    inp = {"cfg": cfg, "state": model.state_dict(), "batch": batch,
           "draws": draws, "query_masks": _query_masks(B),
           "t_weights": torch.rand(B, generator=g) + 0.5,
           "cfg_dropout": dataclasses.replace(
               cfg, denoiser=dataclasses.replace(dc, dropout=0.1)),
           "rs_T": 6, "rs_rounds": rounds, "loaders": loaders,
           "sample": sample}
    path = str(tmp / "in.pt")
    torch.save(inp, path)
    addr = f"tcp://localhost:{_free_port()}"
    _launch([[sys.executable, "-c", WORKER, addr, str(r), path,
              str(tmp / f"out{r}.pt")] for r in range(WORLD)], str(tmp))
    outs = [torch.load(str(tmp / f"out{r}.pt"), weights_only=False)
            for r in range(WORLD)]
    return inp, model, outs


def _query_masks(B):
    """Query masks at the true separators (the parity method: the
    reference's quirk rows carry -1e6 into a LayerNorm, where two float32
    orders of summation differ at O(1))."""
    from raggesture_tpu.datasets.fixtures import tiny_arch_config

    from test_torch_common import parity_query_masks_np

    return {k: torch.as_tensor(v) for k, v in parity_query_masks_np(
        tiny_arch_config().denoiser, B).items()}


def _close(a, b, rel):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    scale = max(float(b.abs().max()), 1e-30)
    return float((a - b).abs().max()) <= rel * scale


def _grads(model, loss):
    model.zero_grad(set_to_none=True)
    loss.backward()
    return {k: p.grad.clone() for k, p in model.denoiser.named_parameters()}


def _same_grads(got, want, rel=1e-6):
    """Every gradient within ``rel`` of the largest gradient element: some
    are zero in exact arithmetic (the key biases under the shift-invariant
    time softmax, the speaker stream's one-key attention) and hold only
    rounding, so a tensor's own scale means nothing for them."""
    scale = max(float(v.abs().max()) for v in want.values())
    worst = max(float((got[k] - v).abs().max()) for k, v in want.items())
    assert worst <= rel * scale, (worst, scale)


def _one_process(model, inp, **kw):
    from raggesture_tpu_torch.models.architecture import training_loss

    sched = model.cfg.diffusion_train.schedule(device="cpu")
    return training_loss(model, sched, inp["batch"],
                         query_masks=inp["query_masks"], **kw)


def test_rank_loss_parts_sum_to_the_global_loss(worker):
    """Ranks whose token-mask sums differ (padded windows): the losses
    summed over the ranks and the all-reduced gradients are the one-process
    loss and gradients of the whole batch, at the same draws."""
    inp, model, outs = worker
    loss, _ = _one_process(model, inp, **inp["draws"])
    grads = _grads(model, loss)
    assert outs[0]["token_mask_sum"] != outs[1]["token_mask_sum"]
    for o in outs:
        assert _close(o["explicit_loss"], loss.detach(), 1e-6)
        _same_grads(o["explicit_grads"], grads)
    assert outs[0]["reduced_elements"] == sum(
        p.numel() for p in model.denoiser.parameters())


def test_a_mean_of_per_rank_losses_is_not_the_global_loss(worker):
    """The trap the global normalization avoids: the mean of the ranks'
    own normalized losses misses the global loss by far more than the
    tolerance the test above holds the sum to."""
    inp, model, outs = worker
    loss, _ = _one_process(model, inp, **inp["draws"])
    naive = (outs[0]["local_loss"] + outs[1]["local_loss"]) / 2
    assert not _close(naive, loss.detach(), 1e-3)


def test_importance_weighted_loss_is_the_global_batch_mean(worker):
    inp, model, outs = worker
    loss, _ = _one_process(model, inp, t_weights=inp["t_weights"],
                           **inp["draws"])
    for o in outs:
        assert _close(o["weighted_loss"], loss.detach(), 1e-6)


def test_draws_from_the_generator_are_the_global_batchs(worker):
    """Every draw made from the step's generator: each rank draws the
    global batch's and takes its rows, so two ranks are one process on the
    whole batch."""
    inp, model, outs = worker
    loss, _ = _one_process(model, inp,
                           generator=torch.Generator().manual_seed(5))
    grads = _grads(model, loss)
    for o in outs:
        assert _close(o["drawn_loss"], loss.detach(), 1e-6)
        _same_grads(o["drawn_grads"], grads)


def test_dropout_masks_are_the_global_batchs_rows(worker):
    """``fused_ctx=False`` with dropout 0.1 over two ranks: the masks of
    each rank's rows are the one-process run's."""
    from raggesture_tpu_torch.models.architecture import MotionDiffusionModel

    inp, _, outs = worker
    dmodel = MotionDiffusionModel(inp["cfg_dropout"]).eval()
    dmodel.load_state_dict(inp["state"])
    loss, _ = _one_process(dmodel, inp, fused_ctx=False,
                           generator=torch.Generator().manual_seed(6))
    grads = _grads(dmodel, loss)
    for o in outs:
        assert _close(o["dropout_loss"], loss.detach(), 1e-6)
        _same_grads(o["dropout_grads"], grads)


def test_synced_resampler_histories_are_equal_and_the_jax_ones(worker):
    """Ragged (t, loss) shards gathered as the JAX package gathers them:
    both ranks' histories bitwise equal, and equal to JAX's resampler fed
    the concatenated pairs through its ``gather_fn``."""
    from raggesture_tpu.diffusion.samplers import (
        LossSecondMomentResampler as JaxResampler,
    )

    inp, _, outs = worker
    rounds = inp["rs_rounds"]
    for k in ("rs_history", "rs_counts", "rs_weights"):
        assert np.array_equal(outs[0][k], outs[1][k]), k
    ref = JaxResampler(inp["rs_T"], history_per_term=2)
    for step in range(len(rounds[0])):
        pairs = [rounds[r][step] for r in range(WORLD)]
        ref._gather = lambda ts, ls, pairs=pairs: (
            np.concatenate([p[0] for p in pairs]),
            np.concatenate([p[1] for p in pairs]))
        ref.update_with_losses(*pairs[0])
    assert np.array_equal(outs[0]["rs_history"], ref._loss_history)
    assert np.array_equal(outs[0]["rs_counts"], ref._loss_counts)
    assert ref._warmed_up()
    assert np.array_equal(outs[0]["rs_weights"], ref.weights())


def test_multi_device_test_gathers_every_ranks_results_in_order(worker):
    inp, _, outs = worker
    want = []
    for r in range(WORLD):
        for b in inp["loaders"][r]:
            for j, name in enumerate(b["sample_name"]):
                if b["valid_mask"][j]:
                    want.append((name, float(b["x"][j]) * 2))
    for o in outs:
        assert [(d["sample_name"], float(d["x"]))
                for d in o["gathered"]] == want


def test_result_blobs_cross_between_the_packages():
    """The port merges blobs the JAX package encoded and padded, and the
    JAX package merges the port's."""
    from raggesture_tpu.train import inference as J

    from raggesture_tpu_torch.train import inference as P

    rng = np.random.RandomState(0)
    ranks = [[{"sample_name": f"r{r}s{i}", "pred": rng.randn(3, 2)}
              for i in range(r + 1)] for r in range(3)]
    for enc, pad, merge in ((J.encode_result_blob, J.pad_result_blob,
                             P.merge_result_blobs),
                            (P.encode_result_blob, P.pad_result_blob,
                             J.merge_result_blobs)):
        blobs = [enc(x) for x in ranks]
        sizes = np.asarray([b.size for b in blobs])
        got = merge(np.stack([pad(b, int(sizes.max())) for b in blobs]),
                    sizes)
        want = [d for x in ranks for d in x]
        assert [d["sample_name"] for d in got] == [
            d["sample_name"] for d in want]
        assert all(np.array_equal(a["pred"], b["pred"])
                   for a, b in zip(got, want))


def _sample_inputs(inp):
    sb = inp["sample"]
    return sb


def test_sharded_sampler_equals_one_process(worker):
    from raggesture_tpu_torch.models.architecture import StagedGenerator

    inp, model, outs = worker
    sb = _sample_inputs(inp)
    gen = StagedGenerator(model, model.cfg.diffusion_test.schedule(
        device="cpu"), fused=False)
    want = gen.sample(sb["batch"], noise=sb["noise"],
                      coef_table=sb["coef_table"],
                      query_masks=sb["query_masks"])
    for o in outs:
        assert set(o["sharded"]) == set(want)
        for k, v in want.items():
            assert o["sharded"][k].shape == v.shape
            assert _close(o["sharded"][k], v, 1e-6), k


def test_sharded_guided_sampler_equals_one_process(worker):
    """The guided loop on each rank's rows (``inv_all`` and the in-seq draw
    sharded on axis 1) against the one-process loop on the whole batch."""
    from raggesture_tpu_torch.diffusion.sampling import ddim_guided_sample_loop
    from raggesture_tpu_torch.models.architecture import StagedGenerator

    inp, model, outs = worker
    sb = _sample_inputs(inp)
    gen = StagedGenerator(model, model.cfg.diffusion_test.schedule(
        device="cpu"), fused=False)
    core = gen._core(sb["batch"], None, sb["noise"], sb["coef_table"],
                     sb["query_masks"])
    noise = core.pop("noise")
    with torch.no_grad():
        want = gen._results(ddim_guided_sample_loop(
            gen._pipeline_prologue(**core), gen.sched, noise,
            inverted_latents=sb["inv_all"], guidance_iters=None,
            init_in_seq=torch.zeros_like(noise),
            in_seq_noise=sb["in_seq_noise"], **gen._common))
    for o in outs:
        for k, v in want.items():
            assert _close(o["sharded_guided"][k], v, 1e-6), k
        assert not torch.equal(o["sharded_guided"]["output_latents"],
                               o["sharded"]["output_latents"])


def test_replicate_tree_gives_every_rank_rank_zeros_values(worker):
    inp, _, outs = worker
    assert outs[0]["replicated_same"] and not outs[1]["replicated_same"]
    for k, v in outs[1]["replicated"].items():
        assert torch.equal(v, inp["state"][k])
        assert torch.equal(outs[0]["replicated"][k], v)


def test_shard_rows_and_batch_follow_the_jax_layout():
    from raggesture_tpu_torch.parallel.mesh import shard_batch, shard_rows

    assert shard_rows(8, 1, 2) == slice(4, 8)
    b = {"a": torch.arange(6), "n": ["x", "y", "z", "u", "v", "w"]}
    got = shard_batch(b, 2, 3)
    assert got["a"].tolist() == [4, 5] and got["n"] == ["v", "w"]
    with pytest.raises(ValueError, match="does not split"):
        shard_rows(5, 0, 2)


# ------------------------------------------------------------ the tool

def _opts(ws):
    root = os.path.join(ws, "beat2")
    return [f"data.{s}.{k}={v}" for s in ("train", "val", "test")
            for k, v in (("data_path", root),
                         ("cache_path", os.path.join(ws, "cache")),
                         ("allow_fake_contacts", True))] + [
        "log_config.tensorboard=False"]


def step_record(opt, args, kwargs):
    """What an optimizer step is about to take, in the optimizer's order:
    the gradients (after the all-reduce and the clip) and the parameters
    (an optimizer step pre-hook)."""
    ps = [p for group in opt.param_groups for p in group["params"]]
    return ([None if p.grad is None else p.grad.detach().clone()
             for p in ps], [p.detach().clone() for p in ps])


# The tool in a process of its own, each of its steps recorded: what the
# update takes, and the gradients the all-reduce was given and gave back.
TOOL = inspect.getsource(step_record) + r'''
import sys, torch
from torch.optim.optimizer import register_optimizer_step_pre_hook
from raggesture_tpu_torch.parallel import mesh
steps, reduced = [], []
register_optimizer_step_pre_hook(
    lambda opt, a, k: steps.append(step_record(opt, a, k)))
reduce = mesh._AllReduceGrads.__call__

def recorded(self, params):
    local = [p.grad.clone() for p in params]
    n = reduce(self, params)
    reduced.append((local, [p.grad.clone() for p in params]))
    return n

mesh._AllReduceGrads.__call__ = recorded
from raggesture_tpu_torch.tools.train import main
main(sys.argv[2:])
torch.save({"steps": steps, "reduced": reduced}, sys.argv[1])
'''


@pytest.fixture(scope="module")
def tool_runs(tmp_path_factory):
    """Two ranks of the tool with ``--distributed --device cpu`` (2 rows a
    rank, 2 epochs, validation, then resumed to a third), and one process
    on the stitched global batches of the two ranks' loaders, each step's
    gradients recorded in both."""
    from test_dataset_build import make_raw_beat2

    from raggesture_tpu_torch.builders import (
        beatx_config_from,
        build_architecture,
        optim_config_from,
    )
    from raggesture_tpu_torch.config import Config
    from raggesture_tpu_torch.datasets.build import build_dataset
    from raggesture_tpu_torch.datasets.sampler import build_dataloader
    from raggesture_tpu_torch.train.runner import (
        DEVICE_BATCH_KEYS,
        train_model,
    )
    from torch.optim.optimizer import register_optimizer_step_pre_hook

    ws = str(tmp_path_factory.mktemp("ws"))
    make_raw_beat2(os.path.join(ws, "beat2"), [("2_scott_0_1_1", "train"),
                                               ("2_scott_0_2_2", "train"),
                                               ("2_scott_0_3_3", "test")],
                   n_sec=12)
    cfg = Config.fromfile(CFG)
    cfg.merge_option_strings(_opts(ws))
    # the window caches first, so that both runs read them
    ds = build_dataset(beatx_config_from(cfg.data.train), None,
                       device="cpu")
    val_ds = build_dataset(beatx_config_from(cfg.data.val), None,
                           device="cpu")
    wd = os.path.join(ws, "dist")

    def ranks(*extra, options=()):
        addr = f"localhost:{_free_port()}"
        outs = _launch([[sys.executable, "-c", TOOL, os.path.join(
                             ws, f"grads{r}.pt"), CFG,
                         "--work-dir", wd, "--device", "cpu",
                         "--device-batch-size", "2", "--log-per-sample",
                         "--distributed", "--coordinator", addr,
                         "--num-processes", str(WORLD), "--process-id",
                         str(r), *extra, "--options", *_opts(ws), *options]
                        for r in range(WORLD)], REPO)
        return outs, [torch.load(os.path.join(ws, f"grads{r}.pt"),
                                 weights_only=True) for r in range(WORLD)]

    outs, recs = ranks()
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        first_rows = len(f.readlines())
    # resumed from latest to a third epoch by every rank; the bank asked
    # for, which streams across processes
    resumed, _ = ranks("--resume-from", "--cond-bank", "32",
                       options=["runner.max_epochs=3"])

    def stitched(dset, shuffle):
        shards = [build_dataloader(dset, 2, 1, shuffle=shuffle,
                                   num_shards=WORLD, shard=r, seed=0)
                  for r in range(WORLD)]

        class Stitched:
            def set_epoch(self, e):
                for s in shards:
                    s.set_epoch(e)

            def __len__(self):
                return len(shards[0])

            def __iter__(self):
                for parts in zip(*shards):
                    yield {k: np.concatenate([p[k] for p in parts])
                           for k in DEVICE_BATCH_KEYS if k in parts[0]}
        return Stitched()

    torch.set_num_threads(1)
    model = build_architecture(cfg.model, device="cpu", seed=0)
    loader = stitched(ds, True)
    one = os.path.join(ws, "one")
    one_steps = []
    hook = register_optimizer_step_pre_hook(
        lambda opt, args, kw: one_steps.append(step_record(opt, args, kw)))
    try:
        state = train_model(model, loader,
                            optim_config_from(cfg, len(loader) * 2),
                            max_epochs=2, workdir=one, checkpoint_interval=1,
                            log_interval=1, tensorboard=False, seed=0,
                            log_per_sample=True,
                            val_loader=stitched(val_ds, False))
    finally:
        hook.remove()
    train_model(build_architecture(cfg.model, device="cpu", seed=0), loader,
                optim_config_from(cfg, len(loader) * 3), max_epochs=3,
                workdir=one, checkpoint_interval=1, log_interval=1,
                tensorboard=False, seed=0, log_per_sample=True, resume=True,
                val_loader=stitched(val_ds, False))
    names = [k for k, _ in model.denoiser.named_parameters()]
    return {"wd": wd, "one": one, "state": state, "outs": outs,
            "resumed": resumed, "first_rows": first_rows, "names": names,
            "steps": [x["steps"] for x in recs],
            "reduced": [x["reduced"] for x in recs], "one_steps": one_steps}


def _metric_rows(wd):
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        return [json.loads(l) for l in f]


def _leaf_grad_errors(names, got, want):
    """Per leaf, |got - want| at its largest over the leaf's scale: the
    leaf's own largest gradient element, or the step's largest for a leaf
    whose gradient is zero in exact arithmetic (``_zero_exact_gradient``:
    only rounding, which the 2-rank sum orders otherwise)."""
    from test_torch_train import _zero_exact_gradient

    step_scale = max(float(w.abs().max()) for w in want if w is not None)
    errs = {}
    for name, g, w in zip(names, got, want):
        assert (g is None) == (w is None), name
        if w is None:
            continue
        own = step_scale if _zero_exact_gradient(name) else \
            max(float(w.abs().max()), 1e-30)
        errs[name] = float((g - w).abs().max()) / own
    return errs


# The first two steps' gradients against the one-process run's, each leaf
# as ``_leaf_grad_errors`` scales it (measured: 2.5e-7 and 3.4e-7).
TOL_STEP_GRAD = 1e-6


def test_two_rank_tool_run_equals_one_process_on_the_stitched_batch(
        tool_runs):
    """Step 1's per-sample losses bitwise equal (each rank's rows take the
    whole batch's float32 operations on the CPU), later steps' losses and
    the validation rows within 1e-5 relative.  At every step the gradient
    the all-reduce gives back is, on both ranks and leaf by leaf, bitwise
    the sum of the two it was given, and both ranks' updates take the same
    gradient; at steps 1 and 2 the gradients the update takes are, leaf by
    leaf, within TOL_STEP_GRAD of the one-process run's, so each rank's
    part is its share of the global batch's loss.  The parameters after
    two steps within 1e-8 of the largest parameter (measured 2.2e-9), the
    frozen codec's bitwise.

    From step 3 on the runs are about lr apart and only the losses are
    held: a gradient element that is only rounding (zero in exact
    arithmetic, or a row of the reference's quirk query masks, whose -1e6
    makes a LayerNorm's result depend on its order of summation) takes
    Adam's normalized step of about lr with whichever sign its rounding
    gives (measured: the parameters 3.1e-5 of the largest apart before
    step 4, and 3.3e-5 after step 8, where lr is 1e-4)."""
    run = tool_runs
    wd, one, state, n = run["wd"], run["one"], run["state"], run["first_rows"]
    rows, ref = _metric_rows(wd)[:n], _metric_rows(one)[:n]
    assert [(r["prefix"], r["step"]) for r in rows] == [
        (r["prefix"], r["step"]) for r in ref]
    first = [r for r in rows if r["prefix"] == "train"][0]
    first_ref = [r for r in ref if r["prefix"] == "train"][0]
    assert len(first["per_sample_loss"]) == 4
    assert first["per_sample_loss"] == first_ref["per_sample_loss"]
    for r, q in zip(rows, ref):
        for k in ("recon_loss", "mse_unweighted", "grad_norm"):
            if k in q:
                assert abs(r[k] - q[k]) <= 1e-5 * max(abs(q[k]), 1.0), (r, q)
    final = torch.load(os.path.join(wd, "checkpoints", "epoch_1.pt"),
                       weights_only=True)
    assert final["step"] == state.step == 8
    names, (r0, r1), one_steps = run["names"], run["steps"], run["one_steps"]
    assert len(r0) == len(r1) == len(one_steps) == 8
    assert [len(x) for x in run["reduced"]] == [8, 8]
    ref_state = state.model.state_dict()
    scale = max(float(v.abs().max()) for v in ref_state.values())
    for (l0, s0), (l1, s1) in zip(run["reduced"][0], run["reduced"][1]):
        assert all(torch.equal(a, b) and torch.equal(a, x + y)
                   for a, b, x, y in zip(s0, s1, l0, l1))
    for i, ((g0, p0), (g1, _), (gw, pw)) in enumerate(zip(r0, r1,
                                                           one_steps)):
        assert all((a is None and b is None) or torch.equal(a, b)
                   for a, b in zip(g0, g1)), i
        if i < 2:
            errs = _leaf_grad_errors(names, g0, gw)
            assert max(errs.values()) <= TOL_STEP_GRAD, (i, errs)
        if i == 2:
            assert max(float((a - b).abs().max())
                       for a, b in zip(p0, pw)) <= 1e-8 * scale
    for k, v in ref_state.items():
        if k.startswith("codec."):
            assert torch.equal(final["model"][k], v), k


def test_only_rank_zero_writes_the_work_dir(tool_runs):
    wd, outs, n = tool_runs["wd"], tool_runs["outs"], tool_runs["first_rows"]
    names = sorted(os.listdir(wd))
    assert len(names) == 5 and all(x.endswith(".log") for x in names[:2])
    assert names[2:] == ["checkpoints", "config.py", "metrics.jsonl"]
    assert sorted(os.listdir(os.path.join(wd, "checkpoints"))) == [
        "epoch_0.pt", "epoch_1.pt", "epoch_2.pt"]
    rows = _metric_rows(wd)[:n]
    assert len([r for r in rows if r["prefix"] == "train"]) == 8
    assert "rank 1 of 2" in outs[1] and "rank 0 of 2" in outs[0]


def test_every_rank_resumes_and_the_bank_streams(tool_runs):
    """Both ranks resumed from the latest checkpoint (the parameters, the
    optimizer, the step and the draws' generator) to a third epoch: its
    rows equal the one-process run resumed the same way within 1e-5; the
    device sample bank asked for streams across processes, with the JAX
    runner's warning on every rank.  Within 1e-4 relative: after eight
    steps the two runs' parameters are about lr apart where a gradient is
    only rounding (the test above), which moves grad_norm by ~1e-5; a
    rank that resumed without its generator would draw other t and noise
    and miss by O(1)."""
    wd, one, n = tool_runs["wd"], tool_runs["one"], tool_runs["first_rows"]
    resumed = tool_runs["resumed"]
    rows, ref = _metric_rows(wd)[n:], _metric_rows(one)[n:]
    assert [(r["prefix"], r["step"], r["epoch"]) for r in rows] == [
        (r["prefix"], r["step"], r["epoch"]) for r in ref]
    assert {r["epoch"] for r in rows} == {2} and len(rows) == 5
    for r, q in zip(rows, ref):
        for k in ("recon_loss", "mse_unweighted", "grad_norm"):
            if k in q:
                assert abs(r[k] - q[k]) <= 1e-4 * abs(q[k]), (r, q)
    for out in resumed:
        assert "resumed from epoch 1 (step 8)" in out
        assert "the mesh spans processes" in out


WAIT_WORKER = r'''
import datetime, sys, time, torch
from raggesture_tpu_torch.parallel import mesh
rank = int(sys.argv[2])
mesh.init_distributed(sys.argv[1], 2, rank, device="cpu",
                      timeout=datetime.timedelta(seconds=2))
mesh.rank0_first(lambda: time.sleep(6) if rank == 0 else None)
try:
    mesh.rank0_first(lambda: 1 / 0)
except ZeroDivisionError:
    print("raised on rank", rank)
print("sum", float(mesh.all_reduce_sum(torch.ones(1))), flush=True)
mesh.shutdown()
'''


def test_ranks_wait_for_rank_zero_longer_than_the_step_timeout(tmp_path):
    """Rank 0 builds (6 s here) while the others wait, past the step
    group's timeout (2 s here; a BEAT2 window cache takes about an hour
    against 600 s): the wait is on a group of its own, and the step's
    collectives work after it.  When rank 0's build raises, the others are
    let go and meet the error themselves."""
    addr = f"tcp://localhost:{_free_port()}"
    outs = _launch([[sys.executable, "-c", WAIT_WORKER, addr, str(r)]
                    for r in range(WORLD)], str(tmp_path), timeout=120)
    for r, out in enumerate(outs):
        assert f"raised on rank {r}" in out and "sum 2.0" in out, out


def test_distributed_tool_needs_its_address_rank_and_size(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "raggesture_tpu_torch.tools.train", CFG,
         "--work-dir", str(tmp_path / "w"), "--device", "cpu",
         "--distributed", "--num-processes", "2"], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "--coordinator" in proc.stderr
    assert not os.path.exists(tmp_path / "w")
