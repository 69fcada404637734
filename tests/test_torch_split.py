"""The split sampling path against the JAX package on the same numpy inputs
and the same weights: kernels K4 ``fused_cross_attention_cached``, K5
``fused_self_attention``, K7 ``fused_cross_block_cached`` and K8
``fused_ffn`` through their plain PyTorch versions (what their wrappers run
on a CPU tensor) against the JAX package's Pallas kernels in interpret mode;
the split branch of ``fused_denoise_ctx`` against JAX's XLA twins; and
3-step ``StagedGenerator(layer_kernel=False)`` / ``(merged_ca=True)``
generation against JAX's fused generator.  The kernels themselves are held
against these plain versions on the card (tests/test_torch_cuda.py and
chip_smoke.py).

Tolerances: float32 on both sides, summed in other orders; 1e-5 on valid
rows for one block (K8 also carries the TPU kernel's erf polynomial, error
< 1.5e-7 before linear2), 3e-5 for a two-layer denoiser call, 1e-4 for
three sampling steps and the decode.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import (
    jax_denoiser_setup,
    numpy_tree,
    parity_query_masks_np,
    port_arch_config,
    port_denoiser,
    randomize_zero_leaves,
    t32,
)

COND_KEYS = ("xf_text", "xf_audio", "xf_spk")
TOL_BLOCK = 1e-5
TOL_DENOISER = 3e-5
TOL_SAMPLE = 1e-4


def _per_head(dense, heads):
    """Dense block-diagonal (..., D, D) contexts -> (..., H, Dh, Dh)."""
    D = dense.shape[-1]
    Dh = D // heads
    c = dense.reshape(dense.shape[:-2] + (heads, Dh, heads, Dh))
    return np.stack([c[..., h, :, h, :] for h in range(heads)], axis=-3)


@functools.lru_cache(maxsize=None)
def _block_case(dead_partner=False):
    """A two-layer JAX denoiser (D 32, 4 heads, T 11: not a multiple of 8),
    the port's copy, and inputs of one layer's blocks: hidden states, a
    token mask with one extra masked token (and optionally a fully masked
    second sequence), true-separator query masks, per-sequence adaLN rows,
    and the cached contexts of conditioned and unconditioned sequences."""
    from raggesture_tpu.models.fused_denoiser import precompute_cross_contexts
    from raggesture_tpu_torch.models.fused_denoiser import pack_split_layers

    cfg, den, params, inp = jax_denoiser_setup(B=2)
    B, T, D = inp["x"].shape
    mask = inp["mask"].copy()
    mask[0, 2] = 0.0
    if dead_partner:
        mask[1] = 0.0
    conds = den.apply(params, inp["word"], inp["audio"], inp["spk"],
                      method=den.encode_conditions)
    cm = np.asarray([1.0, 0.0], np.float32).reshape(B, 1, 1)
    ctx = precompute_cross_contexts(params["params"], cfg, conds,
                                    jnp.asarray(cm))
    ctx3 = np.stack([np.asarray(ctx[(0, k)]) for k in COND_KEYS], axis=1)
    qm = parity_query_masks_np(cfg, B)
    rng = np.random.RandomState(11)
    return dict(
        cfg=cfg, params=params["params"]["block_0"],
        w=pack_split_layers(port_denoiser(cfg, params))[0],
        x=inp["x"], mask=mask[..., None].astype(np.float32),
        qm3=np.stack([qm[k] for k in COND_KEYS], -1), ctx3=ctx3,
        scale=(0.1 * rng.randn(B, 5, D)).astype(np.float32),
        shift=(0.1 * rng.randn(B, 5, D)).astype(np.float32))


def _valid(c):
    return (c["mask"][..., 0] > 0) & (c["qm3"] > 0).all(-1)


@pytest.mark.parametrize("dead_partner", [False, True])
def test_self_attention_plain_version_matches_the_tpu_kernel(dead_partner):
    from raggesture_tpu.ops.pallas.linear_attention_kernel import (
        fused_self_attention as jax_k5,
    )
    from raggesture_tpu_torch.ops.self_attention import fused_self_attention

    c = _block_case(dead_partner)
    H = c["cfg"].num_heads
    want = np.asarray(jax_k5(c["x"], c["mask"], c["scale"][:, 0],
                             c["shift"][:, 0], c["params"]["sa_block"],
                             num_heads=H, interpret=True))
    got = fused_self_attention(t32(c["x"]), t32(c["mask"]),
                               t32(c["scale"][:, 0]), t32(c["shift"][:, 0]),
                               c["w"].sa, H).numpy()
    valid = c["mask"][..., 0] > 0
    assert valid[0].any() and valid[1].any() != dead_partner
    # a fully masked sequence: its time softmax takes its own max, so
    # neither sequence goes 0/0
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[valid], want[valid], atol=TOL_BLOCK)


@pytest.mark.parametrize("j", range(3))
def test_cross_attention_cached_plain_version_matches_the_tpu_kernel(j):
    from raggesture_tpu.ops.pallas.linear_attention_kernel import (
        fused_cross_attention_cached as jax_k4,
    )
    from raggesture_tpu_torch.ops.cross_attention import (
        fused_cross_attention_cached,
    )

    c = _block_case()
    H = c["cfg"].ca_heads
    key = COND_KEYS[j]
    want = np.asarray(jax_k4(c["x"], c["ctx3"][:, j], c["qm3"][..., j, None],
                             c["scale"][:, 1 + j], c["shift"][:, 1 + j],
                             c["params"][f"ca_{key}"], num_heads=H,
                             interpret=True))
    got = fused_cross_attention_cached(
        t32(c["x"]), t32(_per_head(c["ctx3"][:, j], H)),
        t32(c["qm3"][..., j, None]), t32(c["scale"][:, 1 + j]),
        t32(c["shift"][:, 1 + j]), c["w"].cross_block.cas[j], H).numpy()
    # separator rows carry the -1e6 query-mask term through a LayerNorm:
    # catastrophic cancellation, compared nowhere
    valid = _valid(c)
    np.testing.assert_allclose(got[valid], want[valid], atol=TOL_BLOCK)


def test_cross_block_cached_plain_version_matches_the_tpu_kernel():
    from raggesture_tpu.ops.pallas.linear_attention_kernel import (
        fused_cross_block_cached as jax_k7,
    )
    from raggesture_tpu_torch.ops.cross_attention import (
        fused_cross_block_cached,
    )

    c = _block_case()
    H = c["cfg"].ca_heads
    p = c["params"]
    want = np.asarray(jax_k7(
        c["x"], c["ctx3"], c["qm3"], c["scale"][:, 1:4], c["shift"][:, 1:4],
        tuple(p[f"ca_{k}"] for k in COND_KEYS), p["ca_mix"], num_heads=H,
        interpret=True))
    got = fused_cross_block_cached(
        t32(c["x"]), t32(_per_head(c["ctx3"], H)), t32(c["qm3"]),
        t32(c["scale"][:, 1:4]), t32(c["shift"][:, 1:4]),
        c["w"].cross_block, H).numpy()
    valid = _valid(c)
    np.testing.assert_allclose(got[valid], want[valid], atol=TOL_BLOCK)


def test_ffn_plain_version_matches_the_tpu_kernel():
    from raggesture_tpu.ops.pallas.linear_attention_kernel import (
        fused_ffn as jax_k8,
    )
    from raggesture_tpu_torch.ops.ffn import fused_ffn

    c = _block_case()
    want = np.asarray(jax_k8(c["x"], c["scale"][:, 4], c["shift"][:, 4],
                             c["params"]["ffn"], interpret=True))
    got = fused_ffn(t32(c["x"]), t32(c["scale"][:, 4]),
                    t32(c["shift"][:, 4]), c["w"].ffn).numpy()
    np.testing.assert_allclose(got, want, atol=TOL_BLOCK)


# ------------------------------------------- the split denoiser call (JAX)

@pytest.mark.parametrize("merged_ca, ffn_pallas", [
    (False, False), (False, True), (True, False), (True, True)])
def test_split_fused_denoise_ctx_matches_jax(merged_ca, ffn_pallas):
    """The split branch of fused_denoise_ctx (float32 per-head contexts,
    the adaLN table's batch-uniform rows) against JAX's
    fused_denoise_ctx(use_pallas=False, adaln_row=...), conditioned and
    unconditioned sequences paired as sampling pairs them."""
    from raggesture_tpu.models.fused_denoiser import (
        adaln_table as jax_adaln_table,
    )
    from raggesture_tpu.models.fused_denoiser import (
        fused_denoise_ctx as jax_denoise_ctx,
    )
    from raggesture_tpu.models.fused_denoiser import (
        precompute_cross_contexts as jax_contexts,
    )
    from raggesture_tpu_torch.models.fused_denoiser import (
        adaln_table,
        fused_denoise_ctx,
        pack_split_layers,
        precompute_cross_contexts,
        split_mask_rows,
        stack_layer_contexts,
    )

    cfg, den, params, inp = jax_denoiser_setup()
    B = inp["x"].shape[0]
    qm = parity_query_masks_np(cfg, B)
    cm = np.asarray([1.0, 0.0], np.float32).reshape(B, 1, 1)
    jconds = den.apply(params, inp["word"], inp["audio"], inp["spk"],
                       method=den.encode_conditions)
    steps = np.asarray([900, 700, 5], np.int32)
    table = jax_adaln_table(params, cfg, jnp.asarray(steps))
    want = np.asarray(jax_denoise_ctx(
        params, cfg, inp["x"], steps[1:2].repeat(B), inp["mask"],
        jax_contexts(params["params"], cfg, jconds, jnp.asarray(cm)), qm,
        use_pallas=False, adaln_row=table[1]))

    port = port_denoiser(cfg, params)
    conds = {k: t32(v) for k, v in jconds.items()}
    ctx3s = stack_layer_contexts(
        cfg, precompute_cross_contexts(port, conds, t32(cm)), torch.float32)
    src, qm3 = split_mask_rows(t32(inp["mask"]),
                               {k: t32(v) for k, v in qm.items()})
    scale, shift = adaln_table(port, torch.from_numpy(steps))
    got = fused_denoise_ctx(port, t32(inp["x"]), scale[1], shift[1],
                            pack_split_layers(port), ctx3s, src, qm3,
                            layer_kernel=False,
                            merged_ca=merged_ca,
                            ffn_pallas=ffn_pallas).numpy()
    valid = inp["mask"] > 0
    np.testing.assert_allclose(got[valid], want[valid], atol=TOL_DENOISER)


# ------------------------------------------------ the generator (JAX)

SCHEDULE = ("scaled_linear", 1000, "1,1,1", 3)


@functools.lru_cache(maxsize=None)
def _tiny_bundle(seed=0):
    from raggesture_tpu.datasets.fixtures import tiny_arch_config, tiny_batch
    from raggesture_tpu.models import architecture as JA

    jcfg = dataclasses.replace(
        tiny_arch_config(), diffusion_train=JA.DiffusionSpec(
            diffusion_steps=1000))
    jmodel = JA.MotionDiffusionModel(jcfg)
    params = numpy_tree(JA.init_params(jmodel, jax.random.PRNGKey(seed),
                                       tiny_batch(batch=1)))
    randomize_zero_leaves(params["params"]["denoiser"], seed=seed + 1)
    batch = {k: np.array(v) for k, v in tiny_batch(seed=5, batch=2).items()
             if k in ("word", "audio", "speaker_ids", "motion_mask")}
    return jcfg, jmodel, params, batch


def _port_model(jcfg, params):
    from raggesture_tpu_torch.models.architecture import create_model
    from raggesture_tpu_torch.utils.convert_jax import load_jax_params

    model = create_model(port_arch_config(jcfg), device="cpu")
    load_jax_params(model, params)
    return model


@pytest.mark.parametrize("options", [dict(layer_kernel=False),
                                     dict(merged_ca=True)])
def test_split_staged_generator_sample_matches_jax(monkeypatch, options):
    from raggesture_tpu.diffusion.schedules import make_schedule as jax_make
    from raggesture_tpu.models import architecture as JA
    from raggesture_tpu.models.denoiser import latent_motion_mask
    from raggesture_tpu_torch.diffusion.schedules import make_schedule
    from raggesture_tpu_torch.models.architecture import StagedGenerator
    from raggesture_tpu_torch.models.conditioning import scale_func_table
    from raggesture_tpu_torch.models.fused_denoiser import SplitLayerWeights

    jcfg, jmodel, params, batch = _tiny_bundle()
    dc = jcfg.denoiser
    B = batch["motion_mask"].shape[0]
    monkeypatch.setattr(JA, "default_query_masks", lambda cfg, b: {
        k: jnp.asarray(v) for k, v in parity_query_masks_np(cfg, b).items()})
    jgen = JA.StagedGenerator(jmodel, jax.tree_util.tree_map(jnp.asarray,
                                                             params),
                              jax_make(*SCHEDULE), fused=True, **options)
    rng = jax.random.PRNGKey(3)
    want = jgen.sample(batch, rng)

    r_noise, r_coef, _ = jax.random.split(rng, 3)
    noise = np.array(jax.random.normal(r_noise, (B, dc.num_tokens,
                                                 dc.latent_dim)))
    coins = np.array(jax.random.bernoulli(r_coef, 0.5, (SCHEDULE[3],)))
    gen = StagedGenerator(_port_model(jcfg, params), make_schedule(*SCHEDULE),
                          **options)
    assert not gen.layer_kernel
    assert all(isinstance(w, SplitLayerWeights) for w in gen.packs)
    coef = scale_func_table(gen.sched, gen.model.cfg.scale_func,
                            jcfg.diffusion_train.diffusion_steps,
                            coins=torch.from_numpy(coins))
    got = gen.sample(batch, noise=t32(noise), coef_table=coef,
                     query_masks={k: t32(v) for k, v in
                                  parity_query_masks_np(dc, B).items()})

    valid = np.asarray(latent_motion_mask(dc, batch["motion_mask"])) > 0
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.shape == w.shape, k
        if k in ("output_latents", "prev_latentout"):
            g, w = g[valid], w[valid]
        np.testing.assert_allclose(g, w, atol=TOL_SAMPLE, rtol=TOL_SAMPLE,
                                   err_msg=k)


def test_generator_options_take_the_jax_precedence():
    """merged_ca wins over the layer kernel; the layer kernel's packs are
    built only when it runs (else the split path's); the default stays the
    layer kernel, and the split path gives its clip on the CPU (float32
    plain versions)."""
    from raggesture_tpu_torch.diffusion.schedules import make_schedule
    from raggesture_tpu_torch.models.architecture import StagedGenerator
    from raggesture_tpu_torch.models.fused_denoiser import SplitLayerWeights

    jcfg, _, params, batch = _tiny_bundle()
    model = _port_model(jcfg, params)
    sched = make_schedule(*SCHEDULE)
    clips = []
    for options, layer_kernel in ((dict(), True),
                                  (dict(layer_kernel=False), False),
                                  (dict(merged_ca=True), False),
                                  (dict(layer_kernel=True, merged_ca=True),
                                   False)):
        gen = StagedGenerator(model, sched, **options)
        assert gen.layer_kernel == layer_kernel, options
        assert isinstance(gen.packs[0], SplitLayerWeights) != layer_kernel
        assert isinstance(gen.packs[0], dict) == layer_kernel, options
        assert gen.merged_ca == options.get("merged_ca", False)
        if len(clips) < 2:
            clips.append(gen.sample(batch, generator=torch.Generator()
                                    .manual_seed(0))["output_latents"])
    # the same float32 math in other orders: rounding through 3 steps
    torch.testing.assert_close(clips[1], clips[0], atol=TOL_SAMPLE, rtol=0)
