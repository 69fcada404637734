"""The uncached denoiser call and the samplers of retrieval-guided
generation against the JAX package, on the same numpy inputs and weights:
kernel K6 ``fused_cross_attention`` through its plain PyTorch version (what
its wrapper runs on a CPU tensor) against the JAX package's Pallas kernel in
interpret mode; ``fused_denoise`` against JAX's ``fused_denoise`` (its XLA
twin off the TPU); the splice maps, the guidance schedules and the DDIM
in-seq, inversion and guided loops.  K6 itself is held against the plain
version on the card (tests/test_torch_cuda.py and chip_smoke.py).

Tolerances: float32 on both sides, summed in other orders; 2e-5 on valid
rows for one block (as the JAX package holds its Pallas kernels against
their twins), 3e-5 for a two-layer denoiser call, 1e-5 for three sampling
steps of a linear model.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import (
    jax_denoiser_setup,
    parity_query_masks_np,
    port_denoiser,
    t32,
)

TOL_BLOCK = 2e-5
TOL_DENOISER = 3e-5
TOL_LOOP = 1e-5
SCHEDULE = ("scaled_linear", 1000, "1,1,1", 3)


@functools.lru_cache(maxsize=None)
def _setup():
    """A two-layer JAX denoiser (D 32, 4 heads, T 11) and the port's copy."""
    cfg, den, params, inp = jax_denoiser_setup(B=2)
    return cfg, den, params, inp, port_denoiser(cfg, params)


# ----------------------------------------------------------------- K6

@pytest.mark.parametrize("cm", [1.0, 0.0])
@pytest.mark.parametrize("N", [1, 13, 40, 64, 65])
def test_cross_attention_plain_version_matches_the_tpu_kernel(N, cm):
    """One uncached cross attention, N condition rows (13: not a multiple
    of the TPU kernel's 8-row padding; 64 and 65: the card kernel's row
    tile at the shipped widths, and one past it); with cm = 0 the second
    sequence's conditions are dropped (its keys at -1e6, its values the
    bias)."""
    from raggesture_tpu.ops.pallas.linear_attention_kernel import (
        fused_cross_attention as jax_k6,
    )
    from raggesture_tpu_torch.ops.cross_attention import (
        fused_cross_attention,
        pack_cross_attention_kv,
    )

    cfg, _, params, inp, port = _setup()
    B, T, D = inp["x"].shape
    H = cfg.ca_heads
    rng = np.random.RandomState(N)
    xf = rng.randn(B, N, D).astype(np.float32)
    qm = parity_query_masks_np(cfg, B)["xf_text"][..., None]
    cond = np.asarray([1.0, cm], np.float32).reshape(B, 1, 1)
    scale = (0.1 * rng.randn(B, D)).astype(np.float32)
    shift = (0.1 * rng.randn(B, D)).astype(np.float32)
    for key in ("xf_text", "xf_spk"):
        want = np.asarray(jax_k6(
            inp["x"], xf, qm, cond, scale, shift,
            params["params"]["block_1"][f"ca_{key}"], num_heads=H,
            interpret=True))
        launches = fused_cross_attention.launches
        got = fused_cross_attention(
            t32(inp["x"]), t32(xf), t32(qm), t32(cond), t32(scale),
            t32(shift), pack_cross_attention_kv(getattr(port.block(1),
                                                        f"ca_{key}")),
            H).numpy()
        assert fused_cross_attention.launches == launches
        assert np.isfinite(got).all()
        # separator rows carry the -1e6 query-mask term through a
        # LayerNorm: catastrophic cancellation, compared nowhere
        valid = qm[..., 0] > 0
        np.testing.assert_allclose(got[valid], want[valid], atol=TOL_BLOCK,
                                   err_msg=key)


# ---------------------------------------------- the uncached denoiser call

def test_fused_denoise_matches_jax():
    """Per-sample timesteps (the time embedding and the stacked adaLN
    product per call), one conditioned and one dropped sequence, a masked
    token; the plain versions and the wrappers (which take them on the
    CPU) give the same numbers, and so does the eager forward."""
    from raggesture_tpu.models.fused_denoiser import (
        fused_denoise as jax_fused_denoise,
    )
    from raggesture_tpu_torch.models.fused_denoiser import (
        SPLIT_PLAIN,
        fused_denoise,
        pack_unfused_layers,
        stack_adaln_weights,
    )

    cfg, den, params, inp, port = _setup()
    B = inp["x"].shape[0]
    mask = inp["mask"].copy()
    mask[0, 4] = 0.0
    qm = parity_query_masks_np(cfg, B)
    cm = np.asarray([1.0, 0.0], np.float32).reshape(B, 1, 1)
    t = np.asarray([900, 37], np.int32)
    jconds = den.apply(params, inp["word"], inp["audio"], inp["spk"],
                       method=den.encode_conditions)
    want = np.asarray(jax_fused_denoise(
        params, cfg, inp["x"], t, mask, jconds,
        {k: jnp.asarray(v) for k, v in qm.items()}, jnp.asarray(cm)))

    conds = {k: t32(v) for k, v in jconds.items()}
    args = (port, t32(inp["x"]), torch.from_numpy(t.astype(np.int64)),
            t32(mask), conds, {k: t32(v) for k, v in qm.items()}, t32(cm))
    got = fused_denoise(*args, fns=SPLIT_PLAIN).numpy()
    valid = mask > 0
    np.testing.assert_allclose(got[valid], want[valid], atol=TOL_DENOISER)
    # the wrappers on CPU tensors, with the packs built once
    wrapped = fused_denoise(*args, packed_layers=pack_unfused_layers(port),
                            adaln_weights=stack_adaln_weights(port)).numpy()
    np.testing.assert_array_equal(wrapped, got)
    with torch.no_grad():
        eager = port(*args[1:]).numpy()
    np.testing.assert_allclose(eager[valid], got[valid], atol=TOL_DENOISER)


# --------------------------------------------------- the splice and schedules

SPLICES = [
    [[0, 0, 0, 2], [1, 1, 0, 1]],
    [[1, 0, 1, 1], [0, 0, 0, 0], [1, 1, 0, 1]],   # an empty row; overwrite
    [[2, 0, 0, 1]],                               # batch index out of range
    [[0, 1, 0, 2]],                               # past the part's end
    [[0, -1, 0, 1]],                              # negative offset
]


@pytest.mark.parametrize("splice", SPLICES)
def test_splice_maps_match_jax(splice):
    from raggesture_tpu.datasets.fixtures import tiny_arch_config
    from raggesture_tpu.models.architecture import splice_maps as jax_maps
    from raggesture_tpu_torch.models.architecture import splice_maps

    from test_torch_common import port_arch_config

    jdc = tiny_arch_config().denoiser
    dc = port_arch_config(tiny_arch_config()).denoiser
    B, T = 2, jdc.num_tokens
    rows = np.asarray(splice, np.int32)
    try:
        want = jax_maps(jdc, rows, B, T)
    except ValueError as e:
        with pytest.raises(ValueError, match="out of range") as got:
            splice_maps(dc, rows, B, T)
        assert str(got.value) == str(e)
        return
    gather, mask = splice_maps(dc, torch.from_numpy(rows), B, T)
    np.testing.assert_array_equal(gather.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want[1]))


GUIDANCE_NAMES = ("all_one", "all_zero", "none", "all_10", "constant",
                  "decreasing", "increasing", "drop_decreasing_till_25",
                  "step_increasing_from_25", "decreasing_till_25",
                  "increasing_from_25")


def test_guidance_iters_schedules_match_jax():
    from raggesture_tpu.models.architecture import (
        guidance_iters_schedule as jax_schedule,
    )
    from raggesture_tpu_torch.models.architecture import (
        guidance_iters_schedule,
    )

    assert len(GUIDANCE_NAMES) == 11
    for n in (50, 7):
        for name in GUIDANCE_NAMES + ([3] * n,):
            got = guidance_iters_schedule(name, n)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(jax_schedule(name, n)))
    for bad in ("sometimes", [1, 2]):
        with pytest.raises(ValueError):
            guidance_iters_schedule(bad, 50)


# ---------------------------------------------------------- the samplers

def _jax_model(x, t_orig, step_idx):
    """A nontrivial x0-predictor that depends on x and t."""
    return 0.3 * x + 1e-4 * t_orig.astype(jnp.float32)[:, None, None]


def _port_model(x, t_orig, step_idx):
    return 0.3 * x + 1e-4 * t_orig.float()[:, None, None]


def _schedules():
    from raggesture_tpu.diffusion.schedules import make_schedule as jax_make
    from raggesture_tpu_torch.diffusion.schedules import make_schedule

    return jax_make(*SCHEDULE), make_schedule(*SCHEDULE)


def _common():
    from raggesture_tpu.diffusion.gaussian import MeanType as JM
    from raggesture_tpu.diffusion.gaussian import VarType as JV
    from raggesture_tpu_torch.diffusion.gaussian import MeanType, VarType

    return (dict(mean_type=JM.START_X, var_type=JV.FIXED_LARGE),
            dict(mean_type=MeanType.START_X, var_type=VarType.FIXED_LARGE))


def _sampler_inputs(S=3, B=2, T=11, D=8):
    rng = np.random.RandomState(4)
    noise = rng.randn(B, T, D).astype(np.float32)
    x0 = rng.randn(B, T, D).astype(np.float32)
    inv = rng.randn(S, B, T, D).astype(np.float32)
    inv[:, :, 3:] = 0.0                       # targets in tokens 0..2 only
    in_seq = np.zeros((B, T, D), np.float32)
    in_seq[:, 5] = x0[:, 5]
    return noise, x0, inv, in_seq


def test_ddim_loops_match_jax():
    """The in-seq overwrite with JAX's bulk draw fed in, the DDIM
    inversion's per-step stack, and the insertion-guided loop."""
    import raggesture_tpu.diffusion.sampling as JS
    from raggesture_tpu_torch.diffusion import sampling as PS

    jsched, sched = _schedules()
    jc, pc = _common()
    jfn, pfn = _jax_model, _port_model
    noise, x0, inv, in_seq = _sampler_inputs()
    S = sched.num_timesteps
    rng = jax.random.PRNGKey(7)

    want = JS.ddim_sample_loop(jfn, jsched, noise, rng, in_seq=in_seq, **jc)
    _, r_bulk = jax.random.split(rng)
    bulk = np.asarray(jax.random.normal(r_bulk, (S,) + noise.shape))
    got = PS.ddim_sample_loop(pfn, sched, t32(noise), in_seq=t32(in_seq),
                              in_seq_noise=t32(bulk), **pc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_LOOP)

    want = JS.ddim_reverse_sample_loop(jfn, jsched, x0, **jc)
    got = PS.ddim_reverse_sample_loop(pfn, sched, t32(x0), **pc)
    assert tuple(got.shape) == (S,) + x0.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_LOOP)

    gi = np.asarray([2, 1, 3], np.int32)
    want = JS.ddim_guided_sample_loop(jfn, jsched, noise, rng,
                                      inverted_latents=jnp.asarray(inv),
                                      guidance_iters=gi,
                                      init_in_seq=jnp.asarray(in_seq), **jc)
    got = PS.ddim_guided_sample_loop(pfn, sched, t32(noise),
                                     inverted_latents=t32(inv),
                                     guidance_iters=torch.from_numpy(gi),
                                     init_in_seq=t32(in_seq),
                                     in_seq_noise=t32(bulk), **pc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_LOOP)


def test_guided_loop_exact_iters_equals_the_default():
    """The literal gradient descent of insertion guidance moves only the
    rows that the overwrite then replaces: the two paths are equal."""
    from raggesture_tpu_torch.diffusion import sampling as PS

    _, sched = _schedules()
    _, pc = _common()
    pfn = _port_model
    noise, _, inv, in_seq = _sampler_inputs()
    kw = dict(inverted_latents=t32(inv),
              guidance_iters=torch.tensor([4, 10, 2], dtype=torch.int32),
              guidance_lr=0.1, init_in_seq=t32(in_seq), **pc)
    a = PS.ddim_guided_sample_loop(
        pfn, sched, t32(noise), generator=torch.Generator().manual_seed(0),
        **kw)
    b = PS.ddim_guided_sample_loop(
        pfn, sched, t32(noise), generator=torch.Generator().manual_seed(0),
        exact_iters=True, **kw)
    assert torch.equal(a, b)
    # and the descent itself moves the target rows toward the targets
    x = t32(noise)
    moved = PS.guidance_update(x, t32(inv[1]), 3, 0.1)
    assert torch.equal(moved[:, 3:], x[:, 3:])
    assert not torch.equal(moved[:, :3], x[:, :3])
    with pytest.raises(NotImplementedError):
        PS.ddim_guided_sample_loop(pfn, sched, t32(noise), eta=0.5, **kw)
