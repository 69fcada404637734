"""The model options of the port against the JAX package's, on the CPU: the
learned condition encoders (``CondTransformerEncoder``, text or audio
``num_layers > 0``) alone and in a ``GestureDenoiser`` filled by
``load_jax_params`` from a flax init, their attention dropout, the weight
bridge's rule for flax's attention kernels, the three softmax attention
blocks of ``base_attention.py``, every rotation function, one
``StagedGenerator.sample`` with encoders under a cosine / ddim / EPSILON /
FIXED_SMALL test spec, one training step with encoders and an EPSILON
target (float32, both forwards, and bf16), and classifier-free guidance
refused where the model function returns B rows.

Tolerances: float32 on both sides.  Module calls 1e-5 (absolute and
relative; the denoiser on its valid tokens, the separators carrying the
-1e6 query-mask term through a LayerNorm, see
``test_torch_common.parity_query_masks_np``); rotations 1e-5 absolute
(angles near π take the Shepperd branch of either framework's rounding);
the generator 1e-4 on the latents (three steps that each mix the two
halves with coefficients up to ~5), as tests/test_torch_pipeline.py, and
on the decoded parts 1e-4 of each part's largest magnitude (the
axis-angle conversion near π amplifies the latents' differences);
the training step's gradients rtol 1e-3 / atol 1e-6, as
tests/test_torch_train.py, and under bf16 that file's tolerances
(tests/test_torch_train_bf16.py).
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import (
    numpy_tree,
    parity_query_masks_np,
    port_arch_config,
    port_model_and_jax_tree,
    randomize_zero_leaves,
    t32,
)

TOL = 1e-5


def _load(module, tree):
    from raggesture_tpu_torch.utils.convert_jax import load_jax_params

    load_jax_params(module, tree)
    return module.eval()


# ------------------------------------------------------- condition encoders

def _flax_encoder(layers, heads, D=32, ff=48, N=7, B=3, dropout=0.0,
                  seed=0):
    from raggesture_tpu.models.denoiser import CondTransformerEncoder

    enc = CondTransformerEncoder(layers, D, heads, ff, dropout)
    x = np.random.RandomState(seed).randn(B, N, D).astype(np.float32)
    params = numpy_tree(enc.init(jax.random.PRNGKey(seed), x))
    # LayerNorms off their unit init, so that every leaf is exercised
    rng = np.random.RandomState(seed + 1)
    for name, node in params["params"].items():
        if name.startswith("norm") or name == "final_norm":
            node["scale"] = (1 + 0.1 * rng.randn(D)).astype(np.float32)
            node["bias"] = (0.1 * rng.randn(D)).astype(np.float32)
    return enc, params, x


@pytest.mark.parametrize("layers,heads", [(1, 4), (2, 2), (2, 4)])
def test_cond_encoder_matches_flax(layers, heads):
    from raggesture_tpu_torch.models.denoiser import CondTransformerEncoder

    enc, params, x = _flax_encoder(layers, heads)
    want = np.asarray(enc.apply(params, x))
    port = _load(CondTransformerEncoder(layers, 32, heads, 48), params)
    with torch.no_grad():
        got = port(t32(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_cond_encoder_dropout_is_one_mask_for_every_row_and_head():
    """flax's ``broadcast_dropout``: the attention weights (B, H, N, N)
    take one (1, 1, N, N) keep mask.  Identical rows of a batch then come
    out identical under dropout, in flax as in the port; the port draws the
    mask through ``DropoutDraws.shared`` at that shape, so a data-parallel
    rank's rows equal those rows of the whole batch's call."""
    from raggesture_tpu_torch.models.denoiser import CondTransformerEncoder
    from raggesture_tpu_torch.models.layers import DropoutDraws

    enc, params, x = _flax_encoder(2, 4, dropout=0.3)
    x = np.concatenate([x[:1], x[:1], x[1:]])              # rows 0, 1 equal
    j = np.asarray(enc.apply(params, x, deterministic=False,
                             rngs={"dropout": jax.random.PRNGKey(3)}))
    np.testing.assert_array_equal(j[0], j[1])
    assert not np.allclose(j, np.asarray(enc.apply(params, x)))

    port = _load(CondTransformerEncoder(2, 32, 4, 48, dropout=0.3), params)
    shapes = []
    shared = DropoutDraws.shared

    def spy(self, w, rate, shape):
        shapes.append((tuple(w.shape), tuple(shape), rate))
        return shared(self, w, rate, shape)

    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(DropoutDraws, "shared", spy)
        full = port(t32(x), DropoutDraws(torch.Generator().manual_seed(0)))
        rank = port(t32(x[2:]), DropoutDraws(torch.Generator().manual_seed(0),
                                             rows=(2, len(x))))
        plain = port(t32(x))
    B, N = x.shape[:2]
    assert shapes[:2] == [((B, 4, N, N), (1, 1, N, N), 0.3)] * 2
    assert torch.equal(full[0], full[1])
    assert not torch.allclose(full, plain)
    assert torch.equal(rank, full[2:])
    # a mask at the keep rate: its zeros in the rows' weights
    g = torch.Generator().manual_seed(0)
    w = torch.ones(B, 4, N, N)
    dropped = DropoutDraws(g).shared(w, 0.3, (1, 1, N, N))
    assert torch.equal(dropped[0], dropped[-1])
    assert set(torch.unique(dropped).tolist()) <= {
        0.0, torch.tensor(1 / 0.7).item()}


def _encoder_denoiser_cfg(**kw):
    from raggesture_tpu.models.denoiser import DenoiserConfig

    base = dict(latent_dim=32, time_embed_dim=128, num_layers=2,
                num_heads=4, ff_size=64, text_latent_dim=24,
                audio_latent_dim=24, num_speakers=5, max_seq_len=30,
                frame_chunk_size=15, text_num_layers=2, audio_num_layers=1,
                cond_enc_heads=4, cond_enc_ff=48)
    base.update(kw)
    return DenoiserConfig(**base)


@pytest.fixture(scope="module")
def encoder_denoiser():
    """A JAX GestureDenoiser with condition encoders, its flax init (every
    zero-initialised leaf given values) and numpy inputs for one call."""
    from raggesture_tpu.models.denoiser import (
        GestureDenoiser,
        latent_motion_mask,
    )

    cfg = _encoder_denoiser_cfg()
    den = GestureDenoiser(cfg)
    B = 2
    rng = np.random.RandomState(0)
    inp = dict(word=rng.randn(B, 6, 24).astype(np.float32),
               audio=rng.randn(B, 8, 24).astype(np.float32),
               spk=np.asarray([1, 3], np.int32),
               x=rng.randn(B, cfg.num_tokens, 32).astype(np.float32),
               t=np.asarray([5, 900], np.int32),
               mask=np.asarray(latent_motion_mask(cfg, jnp.ones((B, 30)))),
               qm=parity_query_masks_np(cfg, B),
               cm=np.asarray([1.0, 0.0], np.float32).reshape(B, 1, 1))

    def run(mdl):
        cc = mdl.encode_conditions(inp["word"], inp["audio"], inp["spk"])
        return mdl(inp["x"], inp["t"], inp["mask"], cc, inp["qm"], inp["cm"])

    params = numpy_tree(nn.init(run, den)(jax.random.PRNGKey(0)))
    params = {"params": randomize_zero_leaves(dict(params["params"]))}
    want = np.asarray(den.apply(params, method=run))
    conds = den.apply(params, inp["word"], inp["audio"], inp["spk"],
                      method=den.encode_conditions)
    return dict(cfg=cfg, params=params, inp=inp, want=want,
                conds={k: np.asarray(v) for k, v in conds.items()})


def test_denoiser_with_encoders_loaded_from_flax_matches_jax(encoder_denoiser):
    from test_torch_common import port_denoiser

    case = encoder_denoiser
    inp = case["inp"]
    den = port_denoiser(case["cfg"], case["params"])
    assert {"text_encoder", "audio_encoder"} <= {
        n for n, _ in den.named_children()}
    with torch.no_grad():
        conds = den.encode_conditions(t32(inp["word"]), t32(inp["audio"]),
                                      torch.from_numpy(inp["spk"]))
        got = den(t32(inp["x"]), torch.from_numpy(inp["t"]), t32(inp["mask"]),
                  conds, {k: t32(v) for k, v in inp["qm"].items()},
                  t32(inp["cm"])).numpy()
    for k, v in case["conds"].items():
        np.testing.assert_allclose(conds[k].numpy(), v, rtol=TOL, atol=TOL,
                                   err_msg=k)
    valid = inp["mask"] > 0
    np.testing.assert_allclose(got[valid], case["want"][valid], rtol=TOL,
                               atol=TOL)


def test_bridge_reshapes_flax_attention_kernels_and_stays_strict(
        encoder_denoiser):
    """(D, H, Dh) query/key/value kernels and (H, Dh) biases, the (H, Dh, D)
    out kernel; a missing, an unused or a mis-shaped leaf still raises."""
    import copy

    from raggesture_tpu_torch.models.denoiser import (
        DenoiserConfig,
        GestureDenoiser,
    )
    from raggesture_tpu_torch.utils.convert_jax import load_jax_params
    from test_torch_common import same_fields

    case = encoder_denoiser
    attn = case["params"]["params"]["text_encoder"]["attn_0"]
    assert attn["query"]["kernel"].shape == (32, 4, 8)
    assert attn["query"]["bias"].shape == (4, 8)
    assert attn["out"]["kernel"].shape == (4, 8, 32)
    den = GestureDenoiser(same_fields(DenoiserConfig, case["cfg"]))
    load_jax_params(den, case["params"])
    enc = den.text_encoder.attn_0
    np.testing.assert_array_equal(enc.query.weight.detach().numpy(),
                                  attn["query"]["kernel"].reshape(32, 32).T)
    np.testing.assert_array_equal(enc.query.bias.detach().numpy(),
                                  attn["query"]["bias"].reshape(32))
    np.testing.assert_array_equal(enc.out.weight.detach().numpy(),
                                  attn["out"]["kernel"].reshape(32, 32).T)

    def broken(edit):
        tree = copy.deepcopy(case["params"])
        edit(tree["params"]["audio_encoder"]["attn_0"])
        return tree

    cases = [
        (lambda a: a["key"].pop("bias"), KeyError),
        (lambda a: a.update(extra={"kernel": np.zeros((32, 4, 8))}),
         KeyError),
        (lambda a: a["value"].update(kernel=np.zeros((33, 4, 8))),
         ValueError),
        (lambda a: a["out"].update(kernel=np.zeros((4, 8, 31))),
         ValueError),
        (lambda a: a["query"].update(bias=np.zeros((4, 9))), ValueError),
    ]
    for edit, error in cases:
        with pytest.raises(error):
            load_jax_params(GestureDenoiser(same_fields(DenoiserConfig,
                                                        case["cfg"])),
                            broken(edit))


# ------------------------------------------------------ the base attentions

@pytest.mark.parametrize("kind", ("self", "cross", "cross_masked",
                                  "mixed", "mixed_masked"))
def test_base_attention_matches_jax(kind):
    from raggesture_tpu.models import base_attention as J
    from raggesture_tpu_torch.models import base_attention as P

    B, T, N, D, Dc, H, TE = 3, 7, 5, 32, 24, 4, 48
    rng = np.random.RandomState(4)
    x = rng.randn(B, T, D).astype(np.float32)
    xf = rng.randn(B, N, Dc).astype(np.float32)
    emb = rng.randn(B, TE).astype(np.float32)
    src = np.ones((B, T, 1), np.float32)
    src[1, 5:] = 0.0
    cm = np.asarray([1.0, 0.0, 1.0], np.float32).reshape(B, 1, 1)
    qm = (rng.rand(B, T) > 0.3).astype(np.float32)
    masked = kind.endswith("masked")
    if kind == "self":
        jmod, pmod = J.BaseSelfAttention(D, H), P.BaseSelfAttention(D, H, TE)
        args = (x, src, emb)
        kw = {}
    elif kind.startswith("cross"):
        jmod = J.BaseCrossAttention(D, H)
        pmod = P.BaseCrossAttention(D, H, TE, cond_dim=Dc)
        args = (x, xf, emb)
        kw = dict(query_mask=qm, cond_mask=cm) if masked else {}
    else:
        jmod = J.BaseMixedAttention(D, H)
        pmod = P.BaseMixedAttention(D, H, TE, cond_dim=Dc)
        args = (x, xf, emb)
        kw = dict(src_mask=src, cond_mask=cm) if masked else {}
    params = numpy_tree(jmod.init(jax.random.PRNGKey(5), *args, **kw))
    randomize_zero_leaves(params["params"], seed=6)
    want = np.asarray(jmod.apply(params, *args, **kw))
    _load(pmod, params)
    with torch.no_grad():
        got = pmod(*[t32(a) for a in args],
                   **{k: t32(v) for k, v in kw.items()}).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


# ----------------------------------------------------------------- rotations

def _rotation_inputs(rng):
    aa = rng.randn(64, 3).astype(np.float32)
    aa[:4] = [[0, 0, 0], [1e-8, 0, 0], [np.pi - 1e-3, 0, 0], [0, 3.1, 0.1]]
    q = rng.randn(64, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[0] = [-1.0, 1e-4, 0.0, 0.0]          # angle ~2π, tiny vector part
    return aa, q


@pytest.mark.parametrize("fn", (
    "matrix_to_quaternion", "quaternion_to_axis_angle",
    "matrix_to_axis_angle", "matrix_to_rotation_6d", "rotation_6d_to_matrix",
    "axis_angle_to_rotation_6d", "rotation_6d_to_axis_angle", "slerp_6d",
    "qmul", "qinv", "qrot", "qslerp"))
def test_rotation_function_matches_jax(fn):
    from raggesture_tpu.ops import rotations as J
    from raggesture_tpu_torch.ops import rotations as P

    rng = np.random.RandomState(7)
    aa, q = _rotation_inputs(rng)
    mat = np.asarray(J.axis_angle_to_matrix(jnp.asarray(aa)))
    d6 = rng.randn(64, 6).astype(np.float32)
    args = {
        "matrix_to_quaternion": (mat,), "quaternion_to_axis_angle": (q,),
        "matrix_to_axis_angle": (mat,), "matrix_to_rotation_6d": (mat,),
        "rotation_6d_to_matrix": (d6,), "axis_angle_to_rotation_6d": (aa,),
        "rotation_6d_to_axis_angle": (d6,),
        "slerp_6d": (d6, d6[::-1].copy(), 0.3),
        "qmul": (q, q[::-1].copy()), "qinv": (q,),
        "qrot": (q, aa), "qslerp": (q, np.concatenate([q[:2], -q[2:]])[::-1]
                                    .copy(), 0.35),
    }[fn]
    want = np.asarray(getattr(J, fn)(*[jnp.asarray(a) for a in args]))
    got = getattr(P, fn)(*[torch.from_numpy(np.asarray(a)) if isinstance(
        a, np.ndarray) else a for a in args]).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    if fn == "qslerp":   # a still pose: q with itself gives q
        np.testing.assert_allclose(P.qslerp(t32(q), t32(q), 0.5).numpy(), q,
                                   atol=1e-6)


# ------------------------------------------------------------ the generator

SPEC_A = dict(beta_scheduler="cosine", diffusion_steps=1000,
              model_mean_type="epsilon", model_var_type="fixed_small")


def _options_config(test=None, train=None):
    """JAX's tiny config with two text and one audio encoder layer and
    the given diffusion specs."""
    from raggesture_tpu.datasets.fixtures import tiny_arch_config
    from raggesture_tpu.models import architecture as JA

    jcfg = tiny_arch_config()
    return dataclasses.replace(
        jcfg,
        denoiser=dataclasses.replace(jcfg.denoiser, text_num_layers=2,
                                     audio_num_layers=1, cond_enc_heads=2,
                                     cond_enc_ff=48),
        diffusion_train=JA.DiffusionSpec(**(train or dict(
            diffusion_steps=1000))),
        diffusion_test=JA.DiffusionSpec(**(test or dict(SPEC_A,
                                                        respace="ddim3"))))


@pytest.mark.parametrize("fused", (True, False))
def test_staged_generator_under_spec_a_with_encoders_matches_jax(
        monkeypatch, fused):
    """``StagedGenerator.sample`` with condition encoders under cosine
    betas, ``ddim3`` respacing, EPSILON and FIXED_SMALL, against JAX's
    ``StagedGenerator(fused=False).sample`` with the same start noise and
    coins, true-separator query masks on both sides."""
    from raggesture_tpu.datasets.fixtures import tiny_batch
    from raggesture_tpu.models import architecture as JA
    from raggesture_tpu.models.denoiser import latent_motion_mask
    from raggesture_tpu_torch.models.architecture import StagedGenerator
    from raggesture_tpu_torch.models.conditioning import scale_func_table

    jcfg = _options_config()
    dc = jcfg.denoiser
    model, params = port_model_and_jax_tree(jcfg, seed=2)
    batch = {k: np.array(v) for k, v in tiny_batch(seed=5, batch=2).items()
             if k in ("word", "audio", "speaker_ids", "motion_mask")}
    B = 2
    monkeypatch.setattr(JA, "default_query_masks", lambda cfg, b: {
        k: jnp.asarray(v) for k, v in parity_query_masks_np(cfg, b).items()})
    jgen = JA.StagedGenerator(JA.MotionDiffusionModel(jcfg),
                              jax.tree_util.tree_map(jnp.asarray, params),
                              jcfg.diffusion_test.schedule(), fused=False)
    rng = jax.random.PRNGKey(3)
    want = jgen.sample(batch, rng)
    r_noise, r_coef, _ = jax.random.split(rng, 3)
    S = jgen.sched.num_timesteps
    noise = np.array(jax.random.normal(r_noise, (B, dc.num_tokens,
                                                 dc.latent_dim)))
    coins = np.array(jax.random.bernoulli(r_coef, 0.5, (S,)))
    gen = StagedGenerator(model, model.cfg.diffusion_test.schedule(),
                          fused=fused)
    assert gen._common["mean_type"].value == "epsilon"
    coef = scale_func_table(gen.sched, model.cfg.scale_func, 1000,
                            coins=torch.from_numpy(coins))
    got = gen.sample(batch, noise=t32(noise), coef_table=coef,
                     query_masks={k: t32(v) for k, v in
                                  parity_query_masks_np(dc, B).items()})
    valid = np.asarray(latent_motion_mask(dc, batch["motion_mask"])) > 0
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        if k in ("output_latents", "prev_latentout"):
            g, w = g[valid], w[valid]
        # the latents within 1e-4; a decoded part within 1e-4 of its
        # largest magnitude: the 6d -> axis-angle conversion near angle π
        # multiplies the latents' float32 differences (~4e-6 here)
        scale = 1.0 if k.endswith("latentout") or k == "output_latents" \
            else max(1.0, np.abs(w).max())
        np.testing.assert_allclose(g, w, atol=1e-4 * scale, rtol=1e-4,
                                   err_msg=k)


def test_guidance_through_the_b_row_model_functions_is_refused():
    """``classifier_free_guidance_scale > 0`` in the test spec: the port's
    ``generate``, ``StagedGenerator`` and ``invert_exemplars`` raise (the
    JAX package mixes other samples' rows there:
    test_torch_diffusion_options.py::
    test_jax_guidance_through_a_b_row_model_fn_mixes_other_samples)."""
    from raggesture_tpu.datasets.fixtures import tiny_batch
    from raggesture_tpu_torch.models.architecture import (
        StagedGenerator,
        create_model,
        generate,
        invert_exemplars,
    )

    jcfg = _options_config(test=dict(SPEC_A, respace="ddim3",
                                     classifier_free_guidance_scale=2.0))
    model = create_model(port_arch_config(jcfg), device="cpu")
    sched = model.cfg.diffusion_test.schedule()
    batch = {k: np.array(v) for k, v in tiny_batch(seed=5, batch=1).items()}
    with pytest.raises(ValueError, match="make_cfg_model_fn"):
        StagedGenerator(model, sched)
    with pytest.raises(ValueError, match="make_cfg_model_fn"):
        generate(model, sched, batch, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="make_cfg_model_fn"):
        invert_exemplars(model, sched, {}, mean_type=None, var_type=None,
                         cfg_scale=2.0)


# ------------------------------------------------------------- training

@pytest.fixture(scope="module")
def train_case():
    from raggesture_tpu.datasets.fixtures import tiny_batch
    from raggesture_tpu.models import architecture as JA

    jcfg = _options_config(train=dict(SPEC_A))
    _, params = port_model_and_jax_tree(jcfg, seed=1)
    keys = ("motion_upper", "motion_lower", "motion_face", "motion_hands",
            "trans", "facial", "contact", "motion_mask", "word", "audio",
            "speaker_ids")
    batch = {k: np.array(v) for k, v in tiny_batch(seed=4, batch=2).items()
             if k in keys}
    return jcfg, JA.MotionDiffusionModel(jcfg), params, batch


def _grads_as_port(jcfg, grads):
    """JAX's gradient tree in the port's layout: loaded into a port model
    through the bridge (flax's attention kernels reshaped)."""
    from raggesture_tpu_torch.models.architecture import create_model

    g = create_model(port_arch_config(jcfg), device="cpu")
    _load(g, grads)
    return dict(g.denoiser.named_parameters())


@pytest.mark.parametrize("fused_ctx", (True, False))
def test_training_loss_with_encoders_and_epsilon_matches_jax(
        monkeypatch, train_case, fused_ctx):
    """training_loss with condition encoders, cosine betas and an EPSILON
    target: the loss, the per-sample losses and the gradient of every
    denoiser parameter, the encoders' included (through K3's plain
    version's dxf with ``fused_ctx``)."""
    from raggesture_tpu.models import architecture as JA
    from raggesture_tpu_torch.models.architecture import (
        create_model,
        training_loss,
    )
    from test_torch_train import _jax_draws, _parity_masks

    jcfg, jmodel, params, batch = train_case
    qm = _parity_masks(monkeypatch, jcfg, 2)
    rng = jax.random.PRNGKey(1)

    def loss_fn(p):
        return JA.training_loss(jmodel, p, jcfg.diffusion_train.schedule(),
                                batch, rng, return_per_sample=True,
                                fused_ctx=fused_ctx)

    value_and_grad = jax.value_and_grad(loss_fn, has_aux=True)
    if fused_ctx:   # compiled: faster than its eager ops here
        value_and_grad = jax.jit(value_and_grad)
    (v_j, logs_j), g_j = value_and_grad(
        jax.tree_util.tree_map(jnp.asarray, params))
    model = _load(create_model(port_arch_config(jcfg), device="cpu"), params)
    assert model.cfg.diffusion_train.mean_type.value == "epsilon"
    loss, logs = training_loss(
        model, model.cfg.diffusion_train.schedule(),
        {k: torch.from_numpy(v) for k, v in batch.items()},
        return_per_sample=True, query_masks=qm, fused_ctx=fused_ctx,
        **_jax_draws(rng, jcfg, 2))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(v_j), rtol=1e-5)
    np.testing.assert_allclose(logs["per_sample_loss"].detach().numpy(),
                               np.asarray(logs_j["per_sample_loss"]),
                               rtol=1e-5)
    want = _grads_as_port(jcfg, numpy_tree(g_j))
    named = dict(model.denoiser.named_parameters())
    assert any(n.startswith("text_encoder.attn_1.") for n in named)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(),
                                   want[name].detach().numpy(), rtol=1e-3,
                                   atol=1e-6, err_msg=name)


def test_bf16_step_runs_the_encoders_in_bf16_and_matches_jax(
        monkeypatch, train_case):
    """Under ``bf16_compute`` jnp computes the encoders in bf16 (their input
    is the bf16 projection of the bf16 batch, their weights bf16): they are
    batch-fed modules, run on bf16 copies.  The step's loss and gradients
    against JAX's bf16 step at tests/test_torch_train_bf16.py's
    tolerances."""
    from raggesture_tpu.train import loop as JL
    from raggesture_tpu_torch.models.architecture import create_model
    from raggesture_tpu_torch.train.loop import (
        OptimConfig,
        create_train_state,
        make_train_step,
    )
    from test_torch_train import _zero_exact_gradient
    from test_torch_train_bf16 import BF, _bf16_draws, _masks

    jcfg, jmodel, params, batch = train_case
    qm = _masks(monkeypatch, jcfg)
    rng = jax.random.PRNGKey(9)
    jbatch = JL._cast_floats({k: jnp.asarray(v) for k, v in batch.items()},
                             BF)

    def jloss(p):
        loss, logs = JL.training_loss(
            jmodel, JL._cast_floats(p, BF), jcfg.diffusion_train.schedule(),
            jbatch, jax.random.fold_in(rng, 0), fused_ctx=True)
        return loss.astype(jnp.float32), logs

    (jl, _), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))
    model = _load(create_model(port_arch_config(jcfg), device="cpu"), params)
    den = model.denoiser
    assert den.text_encoder in model.batch_fed_modules()
    seen = {}
    hook = den.text_encoder.ff1_0.register_forward_hook(
        lambda m, a, o: seen.update(w=m.weight.dtype, x=a[0].dtype))
    state = create_train_state(model, OptimConfig(lr=1e-3, total_steps=50,
                                                  bf16_compute=True))
    logs = make_train_step(model.cfg.diffusion_train.schedule(),
                           bf16_compute=True)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()},
        query_masks=qm, **_bf16_draws(jax.random.fold_in(rng, 0), jcfg))
    hook.remove()
    assert seen == {"w": torch.bfloat16, "x": torch.bfloat16}
    np.testing.assert_allclose(logs["recon_loss"].item(), float(jl),
                               rtol=5e-3)
    want = _grads_as_port(jcfg, numpy_tree(jg))
    g_scale = max(w.abs().max().item() for w in want.values())
    for name, p in den.named_parameters():
        w = want[name].detach().numpy()
        diff = np.abs(p.grad.numpy() - w).max()
        if _zero_exact_gradient(name) or not np.abs(w).max():
            assert diff <= 1e-3 * g_scale, (name, diff)
        else:
            assert diff <= 5e-2 * np.abs(w).max(), (name, diff)
