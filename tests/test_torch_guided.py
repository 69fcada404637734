"""Generation with the inference options: the port's
``StagedGenerator(fused=False)`` (every denoiser call the uncached
``fused_denoise``) against the JAX package's ``StagedGenerator(fused=False)``
on the same weights, conditions and draws: plain sampling, retrieval-guided
sampling (the DDIM inversion of three exemplars, bucketed to four, the
window splice and insertion guidance), outpainting, the long-form
prev-latent handoff and the inversion self-check; one guided case also
through the port's ``fused=True`` path.  Three DDIM steps; JAX's start
noise, coin flips and in-seq bulk noise are drawn from its key as its
pipelines split it and fed to the port.

Tolerance: float32 on both sides, 1e-4 on valid tokens and on the decoded
parts (three steps, each mixing the two halves with coefficients up to ~5,
then the four decoders), as tests/test_torch_pipeline.py.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import (
    numpy_tree,
    parity_query_masks_np,
    port_arch_config,
    randomize_zero_leaves,
    t32,
)

BATCH_KEYS = ("word", "audio", "speaker_ids", "motion_mask")
COND_KEYS = ("xf_text", "xf_audio", "xf_spk")
SCHEDULE = ("scaled_linear", 1000, "1,1,1", 3)
TOL = 1e-4
Q = 3          # exemplars: the guided pipeline pads them to a bucket of 4
SPLICE = np.asarray([[0, 0, 0, 2], [1, 1, 0, 1], [1, 0, 1, 1]], np.int32)


def _options(name):
    from raggesture_tpu_torch.models.architecture import InferenceOptions

    return {"plain": InferenceOptions(),
            "guided": InferenceOptions(use_inversion=True,
                                       insertion_guidance=True),
            "outpaint": InferenceOptions(outpaint=True),
            "prev": InferenceOptions(use_prev_latent=True)}[name]


@pytest.fixture(scope="module")
def case():
    """The JAX generator's outputs for every case (true-separator query
    masks patched in while its pipelines trace), the inputs, and JAX's
    draws."""
    from raggesture_tpu.datasets.fixtures import tiny_arch_config, tiny_batch
    from raggesture_tpu.diffusion.schedules import make_schedule as jax_make
    from raggesture_tpu.models import architecture as JA
    from raggesture_tpu.models.denoiser import latent_motion_mask

    jcfg = dataclasses.replace(
        tiny_arch_config(), diffusion_train=JA.DiffusionSpec(
            diffusion_steps=1000))
    dc = jcfg.denoiser
    jmodel = JA.MotionDiffusionModel(jcfg)
    params = numpy_tree(JA.init_params(jmodel, jax.random.PRNGKey(0),
                                       tiny_batch(batch=1)))
    randomize_zero_leaves(params["params"]["denoiser"], seed=1)
    batch = {k: np.array(v) for k, v in tiny_batch(seed=5, batch=2).items()
             if k in BATCH_KEYS}
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
    prev = rng.randn(B, T, D).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JA, "default_query_masks", lambda cfg, b: {
            k: jnp.asarray(v)
            for k, v in parity_query_masks_np(cfg, b).items()})
        jgen = JA.StagedGenerator(
            jmodel, jax.tree_util.tree_map(jnp.asarray, params),
            jax_make(*SCHEDULE), fused=False)
        want["plain"] = jgen.sample(batch, key)
        want["guided"] = jgen(batch, key, opts=_options("guided"),
                              re_dict=re_dict)
        want["outpaint"] = jgen(batch, key, opts=_options("outpaint"),
                                re_dict=re_dict)
        want["prev"] = jgen(batch, key, opts=_options("prev"),
                            prev_latent=jnp.asarray(prev))
    # the self-check averages over every token, separators included, where
    # the -1e6 query-mask term's O(1) rounding noise is amplified ~30-fold
    # by the inversion's first step: it runs with query masks of ones
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JA, "default_query_masks", lambda cfg, b: {
            k: jnp.ones((b, cfg.num_tokens)) for k in COND_KEYS})
        check = jgen.inversion_self_check(re_dict)
    want = {k: {n: np.asarray(v) for n, v in out.items()}
            for k, out in want.items()}
    check = {"error_curve": np.asarray(check["error_curve"]),
             "recon_error": np.asarray(check["recon_error"]),
             **{n: np.asarray(v) for n, v in check["recon_decoded"].items()}}

    # the draws, split as pipeline_prologue and the loops split the key
    S = SCHEDULE[3]
    r_noise, r_coef, r_loop = jax.random.split(key, 3)
    _, r_bulk = jax.random.split(r_loop)
    draws = dict(
        noise=np.array(jax.random.normal(r_noise, (B, T, D))),
        coins=np.array(jax.random.bernoulli(r_coef, 0.5, (S,))),
        bulk=np.array(jax.random.normal(r_bulk, (S, B, T, D))))
    valid = np.asarray(latent_motion_mask(dc, batch["motion_mask"])) > 0
    return dict(jcfg=jcfg, params=params, batch=batch, re_dict=re_dict,
                prev=prev, want=want, check=check, draws=draws, valid=valid)


def _generator(case, **options):
    from raggesture_tpu_torch.diffusion.schedules import make_schedule
    from raggesture_tpu_torch.models.architecture import (
        StagedGenerator,
        create_model,
    )
    from raggesture_tpu_torch.utils.convert_jax import load_jax_params

    model = create_model(port_arch_config(case["jcfg"]), device="cpu")
    load_jax_params(model, case["params"])
    return StagedGenerator(model, make_schedule(*SCHEDULE), **options)


def _port_call(gen, case, name):
    from raggesture_tpu_torch.models.conditioning import scale_func_table

    d = case["draws"]
    coef = scale_func_table(gen.sched, gen.model.cfg.scale_func,
                            case["jcfg"].diffusion_train.diffusion_steps,
                            coins=torch.from_numpy(d["coins"]))
    # (T,) masks broadcast to every call's batch, the exemplars' too
    qm = {k: t32(v[0]) for k, v in parity_query_masks_np(
        case["jcfg"].denoiser, 1).items()}
    kw = dict(noise=t32(d["noise"]), coef_table=coef, query_masks=qm)
    if name == "plain":
        return gen.sample(case["batch"], **kw)
    return gen(case["batch"], opts=_options(name), re_dict=case["re_dict"],
               prev_latent=t32(case["prev"]), in_seq_noise=t32(d["bulk"]),
               **kw)


def _assert_matches(got, want, valid):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k].numpy(), want[k]
        assert g.shape == w.shape, k
        if k in ("output_latents", "prev_latentout"):
            g, w = g[valid], w[valid]
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=k)


@pytest.fixture(scope="module")
def unfused(case):
    return _generator(case, fused=False)


@pytest.mark.parametrize("name", ["plain", "guided", "outpaint", "prev"])
def test_unfused_generator_matches_jax(case, unfused, name):
    from raggesture_tpu_torch.models.fused_denoiser import UnfusedLayerWeights

    assert not unfused.fused
    assert all(isinstance(w, UnfusedLayerWeights) for w in unfused.packs)
    got = _port_call(unfused, case, name)
    _assert_matches(got, case["want"][name], case["valid"])
    if name != "plain":
        # the options reached the sampler: the clip differs from plain
        assert not np.allclose(got["output_latents"].numpy(),
                               case["want"]["plain"]["output_latents"])


def test_fused_generator_guided_matches_jax(case):
    """The same guided clip through the cached-context path (on the CPU the
    layer kernel's plain version, float32)."""
    gen = _generator(case)
    assert gen.fused and gen.layer_kernel
    _assert_matches(_port_call(gen, case, "guided"), case["want"]["guided"],
                    case["valid"])


def test_unfused_generator_reads_updated_weights(case):
    """``fused=False`` reads the weights at each run: after an in-place
    update of an adaLN projection, the generator built before it gives the
    clip of one built after it."""
    from raggesture_tpu_torch.models.architecture import StagedGenerator

    gen = _generator(case, fused=False)
    before = _port_call(gen, case, "plain")["output_latents"]
    with torch.no_grad():
        gen.model.denoiser.block(0).ffn.proj_out.emb_layer.weight.add_(0.5)
    after = _port_call(gen, case, "plain")["output_latents"]
    fresh = StagedGenerator(gen.model, gen.sched, fused=False)
    assert torch.equal(after, _port_call(fresh, case, "plain")[
        "output_latents"])
    assert not torch.allclose(before, after)


def test_inversion_self_check_matches_jax(case, unfused):
    qm = {k: torch.ones(case["jcfg"].denoiser.num_tokens) for k in COND_KEYS}
    got = unfused.inversion_self_check(case["re_dict"], query_masks=qm)
    want = case["check"]
    assert tuple(got["error_curve"].shape) == (SCHEDULE[3], Q)
    for k in ("error_curve", "recon_error"):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=TOL,
                                   rtol=TOL, err_msg=k)
    for k, v in got["recon_decoded"].items():
        np.testing.assert_allclose(v.numpy(), want[k], atol=TOL, rtol=TOL,
                                   err_msg=k)


def test_options_are_refused_as_jax_refuses_them(case, unfused):
    """The same combinations fail validation (the JAX package asserts, the
    port raises ValueError), and eta > 0 is refused by both generators."""
    from raggesture_tpu.models.architecture import (
        InferenceOptions as JaxOptions,
    )
    from raggesture_tpu_torch.models.architecture import InferenceOptions

    names = ("use_inversion", "insertion_guidance", "outpaint",
             "use_prev_latent")
    refused = 0
    for flags in itertools.product((False, True), repeat=len(names)):
        kw = dict(zip(names, flags))
        try:
            JaxOptions(**kw).validate()
            jax_ok = True
        except AssertionError:
            jax_ok = False
        if jax_ok:
            InferenceOptions(**kw).validate()
        else:
            refused += 1
            with pytest.raises(ValueError):
                InferenceOptions(**kw).validate()
    assert refused == 9
    with pytest.raises(NotImplementedError, match="eta"):
        unfused(case["batch"], torch.Generator().manual_seed(0),
                InferenceOptions(eta=0.5))
