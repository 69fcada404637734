"""The whole slice: the port's ``StagedGenerator.sample`` against the JAX
package's plain ``StagedGenerator(fused=False).sample`` on the same weights,
conditions, start noise and coin flips."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_common import (
    numpy_tree,
    parity_query_masks_np,
    port_arch_config,
    randomize_zero_leaves,
    t32,
)

BATCH_KEYS = ("word", "audio", "speaker_ids", "motion_mask")
# three steps from the 1000-step schedule: two of them (t > 100) take the
# scale function's coin flips, one its fixed tuned coefficients
SCHEDULE = ("scaled_linear", 1000, "1,1,1", 3)


def _tiny(seed=0):
    from raggesture_tpu.datasets.fixtures import tiny_arch_config, tiny_batch
    from raggesture_tpu.models import architecture as JA

    jcfg = dataclasses.replace(
        tiny_arch_config(), diffusion_train=JA.DiffusionSpec(
            diffusion_steps=1000))
    jmodel = JA.MotionDiffusionModel(jcfg)
    params = numpy_tree(JA.init_params(jmodel, jax.random.PRNGKey(seed),
                                       tiny_batch(batch=1)))
    # the zero-initialised output head and stylization/FFN second linears
    # get random values, so the generated clip depends on every layer
    randomize_zero_leaves(params["params"]["denoiser"], seed=seed + 1)
    batch = {k: np.array(v) for k, v in tiny_batch(seed=5, batch=2).items()
             if k in BATCH_KEYS}
    return jcfg, jmodel, params, batch


def _port_generator(jcfg, params):
    from raggesture_tpu_torch.diffusion.schedules import make_schedule
    from raggesture_tpu_torch.models.architecture import (
        StagedGenerator,
        create_model,
    )
    from raggesture_tpu_torch.utils.convert_jax import load_jax_params

    model = create_model(port_arch_config(jcfg), device="cpu")
    load_jax_params(model, params)
    return StagedGenerator(model, make_schedule(*SCHEDULE))


def test_staged_generator_sample_matches_jax(monkeypatch):
    from raggesture_tpu.diffusion.schedules import make_schedule as jax_make
    from raggesture_tpu.models import architecture as JA
    from raggesture_tpu.models.denoiser import latent_motion_mask
    from raggesture_tpu_torch.models.conditioning import scale_func_table

    jcfg, jmodel, params, batch = _tiny()
    dc = jcfg.denoiser
    B = batch["motion_mask"].shape[0]
    # true-separator query masks on both sides (see parity_query_masks_np)
    monkeypatch.setattr(JA, "default_query_masks", lambda cfg, b: {
        k: jnp.asarray(v) for k, v in parity_query_masks_np(cfg, b).items()})
    jgen = JA.StagedGenerator(jmodel, jax.tree_util.tree_map(jnp.asarray,
                                                             params),
                              jax_make(*SCHEDULE), fused=False)
    rng = jax.random.PRNGKey(3)
    want = jgen.sample(batch, rng)

    # the start noise and the coin flips, drawn as pipeline_prologue does
    r_noise, r_coef, _ = jax.random.split(rng, 3)
    noise = np.array(jax.random.normal(r_noise, (B, dc.num_tokens,
                                                 dc.latent_dim)))
    coins = np.array(jax.random.bernoulli(r_coef, 0.5, (SCHEDULE[3],)))
    gen = _port_generator(jcfg, params)
    coef = scale_func_table(gen.sched, gen.model.cfg.scale_func,
                            jcfg.diffusion_train.diffusion_steps,
                            coins=torch.from_numpy(coins))
    got = gen.sample(batch, noise=t32(noise), coef_table=coef,
                     query_masks={k: t32(v) for k, v in
                                  parity_query_masks_np(dc, B).items()})

    # the separator tokens carry the -1e6 query-mask term through a
    # LayerNorm (implementation noise at O(1)); nothing reads them: self
    # attention masks them out and the decode slices the parts around them
    valid = np.asarray(latent_motion_mask(dc, batch["motion_mask"])) > 0
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.shape == w.shape, k
        if k in ("output_latents", "prev_latentout"):
            g, w = g[valid], w[valid]
        # float32 both sides; three steps, each mixing the two halves with
        # coefficients up to ~5, then the four decoders
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4, err_msg=k)


def test_staged_generator_sample_from_a_generator_is_repeatable():
    """With only a generator: the coins, then the noise, come from it, and
    the clip has the decode's shapes and finite values."""
    jcfg, _, params, batch = _tiny()
    gen = _port_generator(jcfg, params)
    a = gen.sample(batch, generator=torch.Generator().manual_seed(0))
    b = gen.sample(batch, generator=torch.Generator().manual_seed(0))
    c = gen.sample(batch, generator=torch.Generator().manual_seed(1))
    frames = jcfg.denoiser.max_seq_len
    widths = {"pred_upper": 39, "pred_lower": 27, "pred_facepose": 3,
              "pred_hands": 90, "pred_transl": 3, "pred_exps": 100,
              "pred_contact": 4}
    for k, width in widths.items():
        assert tuple(a[k].shape) == (2, frames, width), k
        assert torch.isfinite(a[k]).all(), k
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["output_latents"], c["output_latents"])
