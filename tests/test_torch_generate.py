"""Full inference through the plain denoiser: the port's ``generate`` and
``invert_exemplars`` against the JAX package's on the same weights,
conditions and draws.  ``generate`` at eta 0 (plain) and 0.5 (stochastic
DDIM: outpainting and retrieval-guided), and the ancestral DDPM loop;
three steps each.  JAX's draws are made from its key as its ``generate``
and its loops split it (``r_noise, r_coef, r_loop``; in the plain DDIM
loop ``r, r_pre, r_noise = split(r, 3)`` a step, in the guided loop
``r, r_noise = split(r)``, in DDPM ``split(r, 4)``) and fed to the port
as its draw arguments.

Tolerances: float32 on both sides.  ``generate`` 1e-4 on valid tokens and
on the decoded parts (three steps, each mixing the two halves with
coefficients up to ~5, then the four decoders), as
tests/test_torch_guided.py; ``invert_exemplars`` 3e-5 on valid tokens
(three conditioned steps, no mixing), absolute and relative like the
former: the first step from t = 0 divides by sqrt(1/abar - 1) ~ 0.03, so
the trajectories reach ~100.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import (
    parity_query_masks_np,
    port_arch_config,
    port_model_and_jax_tree,
    t32,
)

SCHEDULE = ("scaled_linear", 1000, "1,1,1", 3)
TOL = 1e-4
TOL_INV = 3e-5
Q = 3
SPLICE = np.asarray([[0, 0, 0, 2], [1, 1, 0, 1], [1, 0, 1, 1]], np.int32)
CASES = {   # name: (options, eta, sampler)
    "plain_eta0": ({}, 0.0, "ddim"),
    "guided_eta0.5": (dict(use_inversion=True, insertion_guidance=True),
                      0.5, "ddim"),
    "outpaint_eta0.5": (dict(outpaint=True), 0.5, "ddim"),
    "ddpm": ({}, 0.0, "ddpm"),
}


def _jax_draws(key, name, B, T, D, S):
    """The draws of JAX's ``generate`` with ``key``, as the port takes
    them: the start noise, the scale function's coins, and the loop's
    in-seq and per-step noise (S, B, T, D), indexed by spaced step."""
    opts, eta, sampler = CASES[name]
    r_noise, r_coef, r = jax.random.split(key, 3)
    draws = dict(noise=np.array(jax.random.normal(r_noise, (B, T, D))),
                 coins=np.array(jax.random.bernoulli(r_coef, 0.5, (S,))),
                 bulk=None, step=None)
    guided = opts.get("insertion_guidance", False)
    if guided or opts.get("outpaint", False):
        r, r_bulk = jax.random.split(r)
        draws["bulk"] = np.array(jax.random.normal(r_bulk, (S, B, T, D)))
    if sampler == "ddpm" or eta:
        step = np.zeros((S, B, T, D), np.float32)
        for i in range(S - 1, -1, -1):
            if sampler == "ddpm":
                r, r_n, _, _ = jax.random.split(r, 4)
            elif guided:
                r, r_n = jax.random.split(r)
            else:
                r, _, r_n = jax.random.split(r, 3)
            step[i] = np.array(jax.random.normal(r_n, (B, T, D)))
        draws["step"] = step
    return draws


def _parity_masks(mp, JA):
    mp.setattr(JA, "default_query_masks", lambda cfg, b: {
        k: jnp.asarray(v) for k, v in parity_query_masks_np(cfg, b).items()})


@pytest.fixture(scope="module")
def case():
    from raggesture_tpu.datasets.fixtures import tiny_arch_config, tiny_batch
    from raggesture_tpu.diffusion.schedules import make_schedule as jax_make
    from raggesture_tpu.models import architecture as JA
    from raggesture_tpu.models.denoiser import latent_motion_mask

    jcfg = dataclasses.replace(
        tiny_arch_config(), diffusion_train=JA.DiffusionSpec(
            diffusion_steps=1000))
    dc = jcfg.denoiser
    model, params = port_model_and_jax_tree(jcfg, seed=3)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    batch = {k: np.array(v) for k, v in tiny_batch(seed=5, batch=2).items()}
    ex = tiny_batch(seed=9, batch=Q)
    B, T, D = 2, dc.num_tokens, dc.latent_dim
    rng = np.random.RandomState(2)
    re_dict = {
        "inv_latents": rng.randn(Q, T, D).astype(np.float32),
        "inv_mask": np.array(latent_motion_mask(
            dc, jnp.ones((Q, dc.max_seq_len)))),
        "inv_conds": {k: np.array(ex[k])
                      for k in ("word", "audio", "speaker_ids")},
        "splice": SPLICE,
        "raw_motion_latents": np.zeros((B, 1, T, D), np.float32),
    }
    re_dict["raw_motion_latents"][:, 0, 1] = rng.randn(B, D)
    re_dict["raw_motion_latents"][1, 0, 7] = rng.randn(D)
    key = jax.random.PRNGKey(4)
    sched = jax_make(*SCHEDULE)
    spec = jcfg.diffusion_test
    common = dict(mean_type=spec.mean_type, var_type=spec.var_type,
                  cfg_scale=spec.classifier_free_guidance_scale)
    want = {}
    with pytest.MonkeyPatch.context() as mp:
        _parity_masks(mp, JA)
        for name, (opts, eta, sampler) in CASES.items():
            cfg = dataclasses.replace(jcfg, inference_type=sampler)
            out = JA.generate(JA.MotionDiffusionModel(cfg), jparams, sched,
                              batch, key, JA.InferenceOptions(eta=eta, **opts),
                              re_dict=re_dict)
            want[name] = {k: np.asarray(v) for k, v in out.items()}
        inv = np.asarray(JA.invert_exemplars(
            JA.MotionDiffusionModel(jcfg), jparams, sched, re_dict,
            **common))
    draws = {name: _jax_draws(key, name, B, T, D, SCHEDULE[3])
             for name in CASES}
    valid = np.asarray(latent_motion_mask(dc, batch["motion_mask"])) > 0
    return dict(jcfg=jcfg, params=params, model=model, batch=batch,
                re_dict=re_dict, want=want, inv=inv, draws=draws,
                valid=valid)


def _port_model(case, sampler):
    from raggesture_tpu_torch.models.architecture import create_model
    from raggesture_tpu_torch.utils.convert_jax import load_jax_params

    if sampler == "ddim":
        return case["model"]
    cfg = dataclasses.replace(port_arch_config(case["jcfg"]),
                              inference_type=sampler)
    model = create_model(cfg, device="cpu")
    load_jax_params(model, case["params"])
    return model


def _query_masks(case):
    return {k: t32(v[0]) for k, v in parity_query_masks_np(
        case["jcfg"].denoiser, 1).items()}


@pytest.mark.parametrize("name", list(CASES))
def test_generate_matches_jax(case, name):
    from raggesture_tpu_torch.diffusion.schedules import make_schedule
    from raggesture_tpu_torch.models.architecture import (
        InferenceOptions,
        generate,
    )
    from raggesture_tpu_torch.models.conditioning import scale_func_table

    opts, eta, sampler = CASES[name]
    model = _port_model(case, sampler)
    assert model.cfg.inference_type == sampler
    sched = make_schedule(*SCHEDULE)
    d = case["draws"][name]
    coef = scale_func_table(sched, model.cfg.scale_func,
                            model.cfg.diffusion_train.diffusion_steps,
                            coins=torch.from_numpy(d["coins"]))
    got = generate(model, sched, case["batch"],
                   opts=InferenceOptions(eta=eta, **opts),
                   re_dict=case["re_dict"], noise=t32(d["noise"]),
                   coef_table=coef,
                   in_seq_noise=None if d["bulk"] is None else t32(d["bulk"]),
                   step_noise=None if d["step"] is None else t32(d["step"]),
                   query_masks=_query_masks(case))
    want = case["want"][name]
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k].numpy(), want[k]
        assert g.shape == w.shape, k
        if k in ("output_latents", "prev_latentout"):
            g, w = g[case["valid"]], w[case["valid"]]
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=k)
    if name != "plain_eta0":
        # the option, the noise or the sampler reached the chain
        assert not np.allclose(got["output_latents"].numpy(),
                               case["want"]["plain_eta0"]["output_latents"])


def test_generate_draws_from_a_generator_in_the_jax_order(case):
    """Without draw arguments a generator draws the start noise, then the
    coefficients, then the loop's noise: the same clip as those draws made
    by hand from a generator of the same seed."""
    from raggesture_tpu_torch.diffusion.schedules import make_schedule
    from raggesture_tpu_torch.models.architecture import (
        InferenceOptions,
        generate,
    )
    from raggesture_tpu_torch.models.conditioning import scale_func_table

    model = case["model"]
    sched = make_schedule(*SCHEDULE)
    dc = model.cfg.denoiser
    opts = InferenceOptions(outpaint=True, eta=0.5)
    shape = (2, dc.num_tokens, dc.latent_dim)
    got = generate(model, sched, case["batch"], torch.Generator().manual_seed(8),
                   opts, case["re_dict"])["output_latents"]
    g = torch.Generator().manual_seed(8)
    noise = torch.randn(shape, generator=g)
    coef = scale_func_table(sched, model.cfg.scale_func,
                            model.cfg.diffusion_train.diffusion_steps,
                            generator=g)
    bulk = torch.randn((3,) + shape, generator=g)
    step = torch.randn((3,) + shape, generator=g)
    want = generate(model, sched, case["batch"], None, opts, case["re_dict"],
                    noise=noise, coef_table=coef, in_seq_noise=bulk,
                    step_noise=step)["output_latents"]
    assert torch.equal(got, want)


def test_invert_exemplars_matches_jax(case):
    from raggesture_tpu_torch.diffusion.schedules import make_schedule
    from raggesture_tpu_torch.models.architecture import invert_exemplars

    model = case["model"]
    spec = model.cfg.diffusion_test
    got = invert_exemplars(model, make_schedule(*SCHEDULE), case["re_dict"],
                           mean_type=spec.mean_type, var_type=spec.var_type,
                           cfg_scale=spec.classifier_free_guidance_scale,
                           query_masks=_query_masks(case))
    assert tuple(got.shape) == case["inv"].shape == (SCHEDULE[3], Q) + tuple(
        case["re_dict"]["inv_latents"].shape[1:])
    valid = case["re_dict"]["inv_mask"] > 0     # the separators are not
    np.testing.assert_allclose(got.numpy()[:, valid], case["inv"][:, valid],
                               atol=TOL_INV, rtol=TOL_INV)


def test_what_generate_and_the_generator_refuse(case):
    """DDPM takes no inversion, guidance, outpainting or handoff (ValueError,
    as in the JAX package), stochastic DDIM needs its noise, and the staged
    generator refuses eta > 0 and names generate()."""
    from raggesture_tpu_torch.diffusion.schedules import make_schedule
    from raggesture_tpu_torch.models.architecture import (
        InferenceOptions,
        StagedGenerator,
        generate,
    )

    sched = make_schedule(*SCHEDULE)
    ddpm = _port_model(case, "ddpm")
    g = torch.Generator().manual_seed(0)
    for opts in (InferenceOptions(use_inversion=True),
                 InferenceOptions(outpaint=True)):
        with pytest.raises(ValueError, match="ddpm"):
            generate(ddpm, sched, case["batch"], g, opts, case["re_dict"])
    with pytest.raises(NotImplementedError, match="eta"):
        generate(case["model"], sched, case["batch"], None,
                 InferenceOptions(eta=0.5),
                 noise=torch.zeros(2, 11, 32),
                 coef_table=torch.zeros(3, 4))
    gen = StagedGenerator(case["model"], sched)
    with pytest.raises(NotImplementedError, match=r"generate\(\)"):
        gen(case["batch"], g, InferenceOptions(eta=0.5))
