"""The sampling cells' per-layer readers, one function per quantity; each
``metrics/<name>.py`` of a sampling cell calls one of them."""

from benchmark.counts import clip, k1, k2
from benchmark.harness import peaks
from benchmark.harness.readers import idle, mfu, roofline, sampling_batches

K1_KERNELS = ("decoder_layer_kernel",)
K2_KERNELS = ("mha_kernel",)


def k1_roofline(run):
    batches = sampling_batches(run)
    if batches is None:
        return None
    s = run.cell.config
    n = s["diffusion_test"]["num_inference_timesteps"] * \
        s["denoiser"]["num_layers"]
    calls = [k1.call(s, 2 * b) + (peaks.BF16_FLOPS,)
             for b in batches for _ in range(n)]
    return roofline(run, K1_KERNELS, calls)


def k2_roofline(run):
    batches = sampling_batches(run)
    if batches is None:
        return None
    calls = [fb + (peaks.TF32_FLOPS,) for b in batches
             for fb in k2.decode(run.cell.config, b)]
    return roofline(run, K2_KERNELS, calls)


def sampling_mfu(run):
    batches = sampling_batches(run)
    if batches is None:
        return None
    return mfu(run, clip.clip(run.cell.config))


def sampling_idle(run):
    return idle(run) if sampling_batches(run) is not None else None
