"""The bf16 wire format of the condition features (``utils/wire.py``,
``bf16_conditions``) and the synthetic fixtures (``datasets/fixtures.py``),
against the JAX package.

Tolerances:
  * the cast: bitwise ``ml_dtypes``' round to nearest even;
  * a training step on bf16 conditions (the loss and every denoiser
    gradient): rtol 1e-5 / rtol 1e-3 atol 1e-6, the float32 step's
    (tests/test_torch_train.py), tighter than tests/test_torch_train_bf16.py's
    5e-3 / 5e-2 of scale: the features are rounded to bf16 on both sides
    and everything after runs in float32;
  * a ``StagedGenerator`` clip on bf16 conditions: 1e-4, the float32
    clip's (tests/test_torch_pipeline.py);
  * the fixtures: bitwise.
~12 s on one worker.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from test_torch_common import (numpy_tree, parity_query_masks_np,
                               port_arch_config, same_fields, t32)


def _bits(t):
    return t.view(torch.int16).numpy().view(np.uint16)


def test_cast_is_ml_dtypes_bitwise():
    from raggesture_tpu_torch.utils.wire import cast_condition_features

    r = np.random.RandomState(0)
    word = r.randn(3, 150, 24).astype(np.float32)
    edge = np.array([0.0, -0.0, np.inf, -np.inf, 1e-40, -3e-39, 3.4e38,
                     1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, 1.0 + 2 ** -9,
                     65504.0, 1.00390625, 1.01171875], np.float32)
    audio = np.concatenate([r.randn(2, 40).astype(np.float32).ravel() * 1e3,
                            edge]).reshape(1, -1)
    sixty_four = r.randn(2, 3)
    dev = torch.ones(2, 3)
    out = cast_condition_features({"word": word, "audio": audio,
                                   "motion": word, "speaker_ids": [1, 2]})
    for k, v in (("word", word), ("audio", audio)):
        assert out[k].dtype == torch.bfloat16 and out[k].device.type == "cpu"
        np.testing.assert_array_equal(_bits(out[k]),
                                      v.astype(ml_dtypes.bfloat16).view(
                                          np.uint16))
    assert out["motion"] is word and out["speaker_ids"] == [1, 2]
    # only float32 host arrays: a tensor (already where it is used) and
    # float64 pass through, as in the JAX package
    same = cast_condition_features({"word": dev, "audio": sixty_four})
    assert same["word"] is dev and same["audio"] is sixty_four


def _tiny():
    from test_torch_train_runtime import _tiny as tiny

    return tiny()


def test_runner_batch_and_bank_ship_the_jax_values():
    from raggesture_tpu.train.runner import device_batch as jax_batch

    from raggesture_tpu_torch.train.cond_bank import DeviceSampleBank
    from raggesture_tpu_torch.train.runner import device_batch

    _, _, _, batch = _tiny()
    want = jax_batch(batch, bf16_conditions=True)
    got = device_batch(batch, "cpu", bf16_conditions=True)
    plain = device_batch(batch, "cpu")
    for k in got:
        w = np.asarray(want[k])
        if k in ("word", "audio"):
            assert w.dtype == ml_dtypes.bfloat16
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), w.astype(np.float32))
            assert not torch.equal(got[k], plain[k])
        else:
            assert torch.equal(got[k], plain[k]), k
    bank = DeviceSampleBank(4, "cpu", bf16_conditions=True)
    rows = bank.stage(dict(batch, sample_idx=np.array([3, 5])), [3, 5])
    for k in rows:
        assert torch.equal(rows[k], got[k]), k


def test_training_step_on_bf16_conditions_matches_jax(monkeypatch):
    """``OptimConfig(bf16_conditions=True)`` builds (the ValueError is gone)
    and the runner's bf16 batch trains as JAX's: the loss and every
    denoiser gradient."""
    from raggesture_tpu.models import architecture as JA
    from raggesture_tpu.train.runner import device_batch as jax_batch

    from raggesture_tpu_torch.models.architecture import training_loss
    from raggesture_tpu_torch.train.loop import OptimConfig
    from raggesture_tpu_torch.train.runner import device_batch
    from test_torch_train import (_jax_draws, _jax_leaf, _jax_params,
                                  _parity_masks, _port_model)

    assert OptimConfig(bf16_conditions=True).bf16_conditions
    jcfg, jmodel, params, batch = _tiny()
    qm = _parity_masks(monkeypatch, jcfg, 2)
    rng = jax.random.PRNGKey(1)
    jb = jax_batch(batch, bf16_conditions=True)

    def loss_fn(p):
        return JA.training_loss(jmodel, p, jcfg.diffusion_train.schedule(),
                                jb, rng, fused_ctx=True)

    (v_j, _), g_j = jax.value_and_grad(loss_fn, has_aux=True)(
        _jax_params(params))
    model = _port_model(jcfg, params)
    pb = {k: v for k, v in device_batch(batch, "cpu", True).items()
          if isinstance(v, torch.Tensor)}
    loss, _ = training_loss(model, model.cfg.diffusion_train.schedule(), pb,
                            query_masks=qm, **_jax_draws(rng, jcfg, 2))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(v_j), rtol=1e-5)
    g_den = numpy_tree(g_j)["params"]["denoiser"]
    for name, p in model.denoiser.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), _jax_leaf(g_den, name),
                                   rtol=1e-3, atol=1e-6, err_msg=name)


def test_generator_clip_on_bf16_conditions_matches_jax(monkeypatch):
    from raggesture_tpu.diffusion.schedules import make_schedule as jax_make
    from raggesture_tpu.models import architecture as JA
    from raggesture_tpu.models.denoiser import latent_motion_mask

    from raggesture_tpu_torch.diffusion.schedules import make_schedule
    from raggesture_tpu_torch.models.architecture import (StagedGenerator,
                                                          create_model)
    from raggesture_tpu_torch.models.conditioning import scale_func_table
    from raggesture_tpu_torch.utils.convert_jax import load_jax_params
    from test_torch_pipeline import SCHEDULE, _tiny as pipeline_tiny

    jcfg, jmodel, params, batch = pipeline_tiny()
    dc = jcfg.denoiser
    B = batch["motion_mask"].shape[0]
    monkeypatch.setattr(JA, "default_query_masks", lambda cfg, b: {
        k: jnp.asarray(v) for k, v in parity_query_masks_np(cfg, b).items()})
    jgen = JA.StagedGenerator(jmodel, jax.tree_util.tree_map(jnp.asarray,
                                                             params),
                              jax_make(*SCHEDULE), fused=False,
                              bf16_conditions=True)
    rng = jax.random.PRNGKey(3)
    want = jgen.sample(batch, rng)
    r_noise, r_coef, _ = jax.random.split(rng, 3)
    noise = np.array(jax.random.normal(r_noise, (B, dc.num_tokens,
                                                 dc.latent_dim)))
    coins = np.array(jax.random.bernoulli(r_coef, 0.5, (SCHEDULE[3],)))
    model = create_model(port_arch_config(jcfg), device="cpu")
    load_jax_params(model, params)
    qm = {k: t32(v) for k, v in parity_query_masks_np(dc, B).items()}
    outs = {}
    for wire in (True, False):
        gen = StagedGenerator(model, make_schedule(*SCHEDULE),
                              bf16_conditions=wire)
        coef = scale_func_table(gen.sched, gen.model.cfg.scale_func,
                                jcfg.diffusion_train.diffusion_steps,
                                coins=torch.from_numpy(coins))
        outs[wire] = gen.sample(batch, noise=t32(noise), coef_table=coef,
                                query_masks=qm)
    valid = np.asarray(latent_motion_mask(dc, batch["motion_mask"])) > 0
    for k in want:
        w, g = np.asarray(want[k]), outs[True][k].numpy()
        if k in ("output_latents", "prev_latentout"):
            g, w = g[valid], w[valid]
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4, err_msg=k)
    assert not torch.equal(outs[True]["output_latents"],
                           outs[False]["output_latents"])
    assert (StagedGenerator(model, make_schedule(*SCHEDULE),
                            bf16_conditions=True).inv_cache_fingerprint()
            != gen.inv_cache_fingerprint())


def test_exemplar_rows_take_the_wire_format():
    """The retrieved exemplars' conditions (``re_dict["inv_conds"]``, float32
    host rows from the database) reach the generator's inversion in the
    wire format: float32 of their bf16 values under ``bf16_conditions``,
    exact without; the speaker ids untouched either way."""
    from raggesture_tpu_torch.datasets.fixtures import tiny_arch_config
    from raggesture_tpu_torch.diffusion.schedules import make_schedule
    from raggesture_tpu_torch.models.architecture import (StagedGenerator,
                                                          create_model)
    from test_torch_pipeline import SCHEDULE

    torch.manual_seed(0)
    model = create_model(tiny_arch_config(), device="cpu")
    r = np.random.RandomState(1)
    word = r.randn(2, 5, 24).astype(np.float32)
    audio = r.randn(2, 3, 24).astype(np.float32)
    re_dict = {"inv_latents": np.zeros((2, 6, 32), np.float32),
               "inv_mask": np.ones((2, 6), np.float32),
               "inv_conds": {"word": word, "audio": audio,
                             "speaker_ids": np.array([3, 1], np.int32)}}
    for on in (False, True):
        gen = StagedGenerator(model, make_schedule(*SCHEDULE), fused=False,
                              graphs=False, bf16_conditions=on)
        got = gen._conditions(re_dict["inv_conds"])
        for k, v in (("word", word), ("audio", audio)):
            want = v.astype(ml_dtypes.bfloat16).astype(np.float32) if on \
                else v
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), want)
        np.testing.assert_array_equal(got["speaker_ids"].numpy(), [3, 1])
    assert re_dict["inv_conds"]["word"] is word


@pytest.mark.parametrize("seed,kw", [(0, {}), (3, dict(batch=3, frames=30,
                                                       audio_frames=8))])
def test_synthetic_batch_is_the_jax_fixture_bitwise(seed, kw):
    from raggesture_tpu.datasets import fixtures as J

    from raggesture_tpu_torch.datasets import fixtures as P

    want = J.synthetic_batch(seed=seed, **kw)
    got = P.synthetic_batch(seed=seed, device="cpu", **kw)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].numpy().dtype == w.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    tiny = P.tiny_batch(seed=seed, device="cpu")
    for k, w in J.tiny_batch(seed=seed).items():
        np.testing.assert_array_equal(tiny[k].numpy(), np.asarray(w))


def test_fixture_configs_are_the_jax_configs():
    from raggesture_tpu.datasets import fixtures as J

    from raggesture_tpu_torch.datasets import fixtures as P

    assert P.tiny_arch_config() == port_arch_config(J.tiny_arch_config())
    assert (P.tiny_arch_config(frames=60, latent=16)
            == port_arch_config(J.tiny_arch_config(frames=60, latent=16)))
    assert P.full_arch_config() == port_arch_config(J.full_arch_config())
    assert dataclasses.asdict(P.full_arch_config().denoiser) == \
        dataclasses.asdict(same_fields(
            type(P.full_arch_config().denoiser),
            J.full_arch_config().denoiser))
