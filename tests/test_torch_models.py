"""The port's models, schedules and sampler against the JAX package on the
same numpy inputs and the same weights (carried across by
``utils.convert_jax.load_jax_params``)."""

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
    same_fields,
    t32,
)

COND_KEYS = ("xf_text", "xf_audio", "xf_spk")


def _tiny_bundle():
    """JAX's tiny MotionDiffusionModel, its parameters, and the port's model
    on the CPU loaded with them."""
    from raggesture_tpu.datasets.fixtures import tiny_arch_config, tiny_batch
    from raggesture_tpu.models.architecture import (
        MotionDiffusionModel,
        init_params,
    )
    from raggesture_tpu_torch.models.architecture import create_model
    from raggesture_tpu_torch.utils.convert_jax import load_jax_params

    jcfg = tiny_arch_config()
    jmodel = MotionDiffusionModel(jcfg)
    params = numpy_tree(init_params(jmodel, jax.random.PRNGKey(0),
                                    tiny_batch(batch=1)))
    model = create_model(port_arch_config(jcfg), device="cpu")
    load_jax_params(model, params)
    return jcfg, jmodel, params, model


# ------------------------------------------------------------------ weights

def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def test_load_jax_params_fills_every_parameter_from_exactly_one_leaf():
    _, _, params, model = _tiny_bundle()
    leaves = list(_leaves(params["params"]))
    named = dict(model.named_parameters())
    assert len(leaves) == len(named)
    assert sum(np.size(v) for _, v in leaves) == sum(
        p.numel() for p in named.values())
    # a Dense kernel (in, out) arrives transposed, a LayerNorm scale as is
    q = params["params"]["denoiser"]["block_0"]["sa_block"]["query"]
    np.testing.assert_array_equal(
        named["denoiser.block_0.sa_block.query.weight"].detach().numpy(),
        np.asarray(q["kernel"]).T)
    pe = params["params"]["codec"]["upper_vae"]["query_pos_decoder"]["pe"]
    np.testing.assert_array_equal(
        named["codec.upper_vae.query_pos_decoder.pe"].detach().numpy(), pe)


@pytest.mark.parametrize("fault", ["missing", "unused", "shape"])
def test_load_jax_params_refuses_a_tree_that_does_not_fit(fault):
    from raggesture_tpu_torch.utils.convert_jax import load_jax_params

    _, _, params, model = _tiny_bundle()
    out = params["params"]["denoiser"]["out"]
    if fault == "missing":
        del out["bias"]
        err = KeyError
    elif fault == "unused":
        out["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
        err = KeyError
    else:
        out["bias"] = np.zeros(3, np.float32)
        err = ValueError
    with pytest.raises(err):
        load_jax_params(model, params)


# ------------------------------------------------------- the eager denoiser

@pytest.mark.parametrize("cond", [1.0, 0.0])
def test_eager_denoiser_matches_jax(cond):
    """One call, D 32, 4 heads, 2 layers, zero-init leaves randomised,
    true-separator query masks, conditions kept (cm 1) and dropped (cm 0)."""
    cfg, den, params, inp = jax_denoiser_setup()
    B = inp["x"].shape[0]
    qm = parity_query_masks_np(cfg, B)
    cm = np.full((B, 1, 1), cond, np.float32)
    jconds = den.apply(params, inp["word"], inp["audio"], inp["spk"],
                       method=den.encode_conditions)
    want = np.asarray(den.apply(params, inp["x"], inp["t"], inp["mask"],
                                jconds, qm, cm))

    port = port_denoiser(cfg, params)
    with torch.no_grad():
        conds = port.encode_conditions(t32(inp["word"]), t32(inp["audio"]),
                                       torch.from_numpy(inp["spk"]))
        for k in COND_KEYS:
            np.testing.assert_allclose(conds[k].numpy(),
                                       np.asarray(jconds[k]), atol=1e-6)
        got = port(t32(inp["x"]), torch.from_numpy(inp["t"]),
                   t32(inp["mask"]), conds,
                   {k: t32(v) for k, v in qm.items()}, t32(cm)).numpy()
    valid = inp["mask"] > 0
    # float32 both sides, summed in other orders over two layers
    np.testing.assert_allclose(got[valid], want[valid], atol=3e-5)


def test_default_query_masks_keep_the_reference_quirk():
    from raggesture_tpu.models.denoiser import DenoiserConfig as JDC
    from raggesture_tpu.models.denoiser import (
        default_query_masks as jax_masks,
    )
    from raggesture_tpu_torch.models.denoiser import (
        DenoiserConfig,
        default_query_masks,
    )

    for jcfg in (JDC(), JDC(max_seq_len=30)):
        cfg = same_fields(DenoiserConfig, jcfg)
        got = default_query_masks(cfg, 2)
        want = jax_masks(jcfg, 2)
        for k in COND_KEYS:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    m = default_query_masks(DenoiserConfig(), 1)["xf_text"][0]
    assert torch.nonzero(m == 0).flatten().tolist() == [10, 20, 30]


# ---------------------------------------------- the sampling apply-path (K1)

def test_fused_denoise_ctx_matches_jax_module():
    """The layer-kernel path (float32 packs, per-head cached contexts, the
    adaLN table) against the JAX eager module, with conditioned and
    unconditioned sequences paired as sampling pairs them."""
    from raggesture_tpu.models.fused_denoiser import (
        adaln_table as jax_adaln_table,
    )
    from raggesture_tpu.models.fused_denoiser import (
        precompute_cross_contexts as jax_contexts,
    )
    from raggesture_tpu_torch.models.fused_denoiser import (
        adaln_table,
        fused_denoise_ctx,
        layer_kernel_mask_rows,
        pack_layers,
        precompute_cross_contexts,
        stack_layer_contexts,
    )

    cfg, den, params, inp = jax_denoiser_setup()
    B = inp["x"].shape[0]
    t = np.full((B,), 700, np.int32)           # sampling shares t
    qm = parity_query_masks_np(cfg, B)
    cm = np.asarray([1.0, 0.0], np.float32).reshape(B, 1, 1)
    jconds = den.apply(params, inp["word"], inp["audio"], inp["spk"],
                       method=den.encode_conditions)
    want = np.asarray(den.apply(params, inp["x"], t, inp["mask"], jconds,
                                qm, cm))

    port = port_denoiser(cfg, params)
    conds = {k: t32(v) for k, v in jconds.items()}
    ctx = precompute_cross_contexts(port, conds, t32(cm))
    jctx = jax_contexts(params["params"], cfg, jconds, jnp.asarray(cm))
    H, Dh = cfg.ca_heads, cfg.latent_dim // cfg.ca_heads
    for key, c in ctx.items():
        dense = np.asarray(jctx[key]).reshape(B, H, Dh, H, Dh)
        np.testing.assert_allclose(
            c.numpy(), np.stack([dense[:, h, :, h] for h in range(H)], 1),
            atol=1e-6)

    steps = torch.tensor([900, 700, 5])
    scale, shift = adaln_table(port, steps)
    jtab = np.asarray(jax_adaln_table(params, cfg, jnp.asarray(steps.numpy())))
    np.testing.assert_allclose(
        torch.stack([scale, shift], 3).reshape(len(steps), -1).numpy(), jtab,
        atol=1e-5)

    m_rows, qm_rows = layer_kernel_mask_rows(
        t32(inp["mask"]), {k: t32(v) for k, v in qm.items()})
    got = fused_denoise_ctx(
        port, t32(inp["x"]), scale[1], shift[1],
        pack_layers(port, torch.float32),
        stack_layer_contexts(cfg, ctx, torch.float32), m_rows,
        qm_rows).numpy()
    valid = inp["mask"] > 0
    np.testing.assert_allclose(got[valid], want[valid], atol=3e-5)


# ---------------------------------------------------- VAE and codec decode

def test_codec_decode_matches_jax():
    """The four part-VAE decoders (attention through K2's plain version)
    and the 6d -> axis-angle split, at the tiny config."""
    jcfg, jmodel, params, model = _tiny_bundle()
    dc = jcfg.denoiser
    z = np.random.RandomState(3).randn(2, dc.num_tokens,
                                       dc.latent_dim).astype(np.float32)
    want = jmodel.apply(params, jnp.asarray(z), method=jmodel.decode_latents)
    got = model.decode_latents(t32(z))
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        # float32 both sides: post-norm encoder layers, softmax attention
        np.testing.assert_allclose(got[k].numpy(), w, atol=1e-4, rtol=1e-4,
                                   err_msg=k)


# ---------------------------------------------------- schedules and DDIM

@pytest.mark.parametrize("steps, respace, n", [
    (1000, "15,15,8,6,6", 50),   # the shipped sampling schedule
    (100, "2,2,2,2,2", 10),      # the tiny config's
    (1000, None, None),          # the training schedule, not respaced
])
def test_schedule_tables_match_jax(steps, respace, n):
    import dataclasses

    from raggesture_tpu.diffusion.schedules import make_schedule as jax_make
    from raggesture_tpu_torch.diffusion.schedules import make_schedule

    got = make_schedule("scaled_linear", steps, respace, n)
    want = jax_make("scaled_linear", steps, respace, n)
    assert got.num_timesteps == want.num_timesteps
    assert got.original_num_steps == want.original_num_steps
    for f in dataclasses.fields(want):
        w = getattr(want, f.name)
        if isinstance(w, int):
            continue
        np.testing.assert_allclose(getattr(got, f.name).numpy(),
                                   np.asarray(w), rtol=1e-6, err_msg=f.name)


def test_ddim_sample_loop_matches_jax_with_a_shared_model():
    from raggesture_tpu.diffusion.sampling import (
        ddim_sample_loop as jax_loop,
    )
    from raggesture_tpu.diffusion.schedules import make_schedule as jax_make
    from raggesture_tpu_torch.diffusion.sampling import ddim_sample_loop
    from raggesture_tpu_torch.diffusion.schedules import make_schedule

    w = np.random.RandomState(1).randn(8, 8).astype(np.float32) * 0.3
    noise = np.random.RandomState(2).randn(2, 5, 8).astype(np.float32)

    def jax_fn(x, t_orig, step_idx):
        s = (t_orig.astype(jnp.float32) / 1000.0)[:, None, None]
        return jnp.tanh(x @ w) * (1.0 - s) + 0.01 * step_idx

    def port_fn(x, t_orig, step_idx):
        s = (t_orig.float() / 1000.0)[:, None, None]
        return torch.tanh(x @ t32(w)) * (1.0 - s) + 0.01 * step_idx

    args = ("scaled_linear", 1000, "15,15,8,6,6", 50)
    want = jax_loop(jax_fn, jax_make(*args), jnp.asarray(noise),
                    jax.random.PRNGKey(0))
    got = ddim_sample_loop(port_fn, make_schedule(*args), t32(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_scale_func_table_and_mixing_match_jax():
    from raggesture_tpu.diffusion.schedules import make_schedule as jax_make
    from raggesture_tpu.models.conditioning import ScaleFuncConfig as JSF
    from raggesture_tpu.models.conditioning import mix_outputs as jax_mix
    from raggesture_tpu.models.conditioning import (
        scale_func_table as jax_table,
    )
    from raggesture_tpu_torch.diffusion.schedules import make_schedule
    from raggesture_tpu_torch.models.conditioning import (
        ScaleFuncConfig,
        mix_outputs,
        scale_func_table,
    )

    args = ("scaled_linear", 1000, "15,15,8,6,6", 50)
    sched, jsched = make_schedule(*args), jax_make(*args)
    key = jax.random.PRNGKey(11)
    coins = np.array(jax.random.bernoulli(key, 0.5,
                                         (jsched.num_timesteps,)))
    want = np.asarray(jax_table(key, jsched, JSF(), 1000))
    got = scale_func_table(sched, ScaleFuncConfig(), 1000,
                           coins=torch.from_numpy(coins))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    # coins from a generator: a table of the same form
    g = scale_func_table(sched, ScaleFuncConfig(), 1000,
                         generator=torch.Generator().manual_seed(0))
    assert g.shape == got.shape and torch.equal(g[sched.timestep_map <= 100],
                                                got[sched.timestep_map <= 100])

    out2 = np.random.RandomState(4).randn(4, 43, 8).astype(np.float32)
    js = np.linspace(0.5, 1.5, 43).astype(np.float32)
    for step in (0, 49):
        np.testing.assert_allclose(
            mix_outputs(t32(out2), 2, got, step, t32(js)).numpy(),
            np.asarray(jax_mix(jnp.asarray(out2), 2, jnp.asarray(want), step,
                               jnp.asarray(js))), rtol=1e-6, atol=1e-6)
