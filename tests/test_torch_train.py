"""The training slice: the port's codec encode, training denoiser, training
loss and train step against the JAX package's default training step
(``fused_ctx=True``), on the same weights and the same random draws.

The JAX draws are made the way ``training_loss`` makes them and handed to
the port: ``r_enc, r_t, r_noise, r_cond, _ = split(rng, 5)``, part i's
encode eps from ``fold_in(r_enc, i)``.  The zero-initialised leaves of the
denoiser get random values so that every gradient is non-trivial, and the
query masks sit at the true separators on both sides (see
``test_torch_common.parity_query_masks_np``).
"""

import functools

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

PARTS = ("upper", "hands", "face", "lowertrans")
BATCH_KEYS = ("motion_upper", "motion_lower", "motion_face", "motion_hands",
              "trans", "facial", "contact", "motion_mask", "word", "audio",
              "speaker_ids")


@functools.lru_cache(maxsize=None)
def _tiny():
    """JAX's tiny model and parameters (numpy), and a batch of two."""
    from raggesture_tpu.datasets.fixtures import tiny_arch_config, tiny_batch
    from raggesture_tpu.models import architecture as JA

    jcfg = tiny_arch_config()
    jmodel = JA.MotionDiffusionModel(jcfg)
    params = numpy_tree(JA.init_params(jmodel, jax.random.PRNGKey(0),
                                       tiny_batch(batch=1)))
    randomize_zero_leaves(params["params"]["denoiser"], seed=1)
    batch = {k: np.array(v) for k, v in tiny_batch(seed=4, batch=2).items()
             if k in BATCH_KEYS}
    return jcfg, jmodel, params, batch


def _port_model(jcfg, params):
    from raggesture_tpu_torch.models.architecture import create_model
    from raggesture_tpu_torch.utils.convert_jax import load_jax_params

    model = create_model(port_arch_config(jcfg), device="cpu")
    load_jax_params(model, params)
    return model


def _port_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _jax_params(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


def _parity_masks(monkeypatch, jcfg, B):
    """True-separator query masks on both sides: JAX's training_loss takes
    its masks from default_query_masks."""
    from raggesture_tpu.models import architecture as JA

    masks = parity_query_masks_np(jcfg.denoiser, B)
    monkeypatch.setattr(JA, "default_query_masks", lambda cfg, b: {
        k: jnp.asarray(v) for k, v in masks.items()})
    return {k: t32(v) for k, v in masks.items()}


def _jax_draws(rng, jcfg, B):
    """The draws of JAX's training_loss(rng), as port tensors."""
    r_enc, r_t, r_noise, r_cond, _ = jax.random.split(rng, 5)
    c = jcfg.codec
    shape = (B, c.num_frames // c.frame_chunk_size, c.latent_dim)
    eps = {p: t32(jax.random.normal(jax.random.fold_in(r_enc, i), shape))
           for i, p in enumerate(PARTS)}
    t = jax.random.randint(r_t, (B,), 0, jcfg.diffusion_train.diffusion_steps)
    noise = jax.random.normal(r_noise, (B, jcfg.denoiser.num_tokens,
                                        jcfg.denoiser.latent_dim))
    cond = jax.random.randint(r_cond, (B, 1, 1), 0, 100) % 10 > 0
    return dict(enc_eps=eps, t=torch.from_numpy(np.array(t)).long(),
                noise=t32(noise), cond_mask=t32(np.array(cond, np.float32)))


def _jax_leaf(tree, name):
    """The JAX leaf of a port parameter name, in the port's layout."""
    *path, last = name.split(".")
    node = tree
    for key in path:
        node = node[key]
    if last == "weight":
        for key in ("kernel", "scale", "embedding"):
            if key in node:
                leaf = np.asarray(node[key])
                return leaf.T if key == "kernel" else leaf
    return np.asarray(node[last])


# Parameters whose gradient is zero in exact arithmetic, where each
# framework returns its own float32 rounding noise: the key biases feed
# only a time softmax, which a per-column shift leaves unchanged; and the
# speaker stream has one token, so its every context row is the same v and
# a feature-softmaxed query (summing to one) reads v whatever it is: the
# query side of that cross-attention (its norm and query) gets no signal.
def _zero_exact_gradient(name):
    return name.endswith("key.bias") or name.split(".")[1:3] in (
        ["ca_xf_spk", "query"], ["ca_xf_spk", "norm"])


# ------------------------------------------------------------------ codec

def test_aa_feature_to_6d_matches_jax():
    """Random poses, exact zeros and angles below the 1e-6 Taylor switch."""
    from raggesture_tpu.ops.rotations import aa_feature_to_6d as jax_fn
    from raggesture_tpu_torch.ops.rotations import aa_feature_to_6d

    rng = np.random.RandomState(0)
    x = rng.randn(3, 7, 5 * 3).astype(np.float32)
    x[0, :, :3] = 0.0
    x[1, :, 3:6] = 3e-7 * rng.randn(7, 3)
    x[2, :, 6:9] *= 3.0
    np.testing.assert_allclose(aa_feature_to_6d(t32(x)).numpy(),
                               np.asarray(jax_fn(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_codec_encode_matches_jax():
    """part_features, encode_dist (mu, logvar) and the rsampled encode with
    JAX's per-part eps: four 2-layer VAEs, float32 both sides."""
    from raggesture_tpu.models.codec import part_features as jax_features
    from raggesture_tpu_torch.models.codec import part_features

    jcfg, jmodel, params, batch = _tiny()
    jp = _jax_params(params)
    model = _port_model(jcfg, params)
    pb = _port_batch(batch)
    keys = ("motion_upper", "motion_lower", "motion_face", "motion_hands",
            "trans", "facial", "contact")
    want = jax_features(*(jnp.asarray(batch[k]) for k in keys))
    got = part_features(*(pb[k] for k in keys))
    for p in PARTS:
        np.testing.assert_allclose(got[p].numpy(), np.asarray(want[p]),
                                   rtol=1e-6, atol=1e-6, err_msg=p)

    mu_j, lv_j = jmodel.apply(jp, batch, method=jmodel.encode_motion_dist)
    mu, lv = model.encode_motion_dist(pb)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), atol=2e-5)
    np.testing.assert_allclose(lv.numpy(), np.asarray(lv_j), atol=2e-5)

    rng = jax.random.PRNGKey(9)
    z_j, tm_j = jmodel.apply(jp, batch, rng=rng, sample=True,
                             method=jmodel.encode_motion)
    draws = _jax_draws(jax.random.PRNGKey(0), jcfg, 2)
    shape = draws["enc_eps"]["upper"].shape
    eps = {p: t32(jax.random.normal(jax.random.fold_in(rng, i), shape))
           for i, p in enumerate(PARTS)}
    z, tm = model.encode_motion(pb, eps)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), atol=2e-5)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(tm_j))


# --------------------------------------------------------------- denoiser

def test_train_denoise_ctx_matches_jax():
    """One training-path denoiser call (contexts through K3's plain
    version) against JAX's train_denoise_ctx, conditions kept and
    dropped."""
    from raggesture_tpu.models.denoiser import latent_motion_mask
    from raggesture_tpu.models.fused_denoiser import (
        train_denoise_ctx as jax_fn,
    )
    from raggesture_tpu_torch.models.fused_denoiser import train_denoise_ctx

    jcfg, jmodel, params, batch = _tiny()
    jp = _jax_params(params)
    model = _port_model(jcfg, params)
    dn = jcfg.denoiser
    B, T = 2, dn.num_tokens
    x = np.random.RandomState(7).randn(B, T, dn.latent_dim).astype(np.float32)
    t = np.asarray([3, 77], np.int32)
    mask = np.asarray(latent_motion_mask(dn, jnp.ones((B, dn.max_seq_len))))
    qm = parity_query_masks_np(dn, B)
    cm = np.asarray([1.0, 0.0], np.float32).reshape(B, 1, 1)
    jconds = jmodel.apply(jp, batch, method=jmodel.encode_conditions)
    want = np.asarray(jax_fn(jp, dn, x, t, mask, jconds, qm, cm))
    with torch.no_grad():
        conds = model.encode_conditions(_port_batch(batch))
        got = train_denoise_ctx(model.denoiser, t32(x),
                                torch.from_numpy(t).long(), t32(mask), conds,
                                {k: t32(v) for k, v in qm.items()},
                                t32(cm)).numpy()
    valid = mask > 0
    np.testing.assert_allclose(got[valid], want[valid], rtol=2e-5,
                               atol=2e-6)


def test_training_loss_and_every_denoiser_gradient_match_jax(monkeypatch):
    """training_loss(fused_ctx=True): the loss, the logs and the gradient
    of every denoiser parameter, within rtol 1e-3 / atol 1e-6 (JAX's
    tolerances for its fused path against its flax path)."""
    from raggesture_tpu.models import architecture as JA
    from raggesture_tpu_torch.models.architecture import training_loss

    jcfg, jmodel, params, batch = _tiny()
    qm = _parity_masks(monkeypatch, jcfg, 2)
    sched_j = jcfg.diffusion_train.schedule()
    rng = jax.random.PRNGKey(1)    # conditions kept for one, dropped for one

    def loss_fn(p):
        return JA.training_loss(jmodel, p, sched_j, batch, rng,
                                return_per_sample=True, fused_ctx=True)

    (v_j, logs_j), g_j = jax.value_and_grad(loss_fn, has_aux=True)(
        _jax_params(params))
    model = _port_model(jcfg, params)
    sched = model.cfg.diffusion_train.schedule()
    draws = _jax_draws(rng, jcfg, 2)
    loss, logs = training_loss(model, sched, _port_batch(batch),
                               return_per_sample=True, query_masks=qm,
                               **draws)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(v_j), rtol=1e-5)
    for k in ("mse_unweighted", "per_sample_loss"):
        np.testing.assert_allclose(logs[k].detach().numpy(),
                                   np.asarray(logs_j[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(logs["t"].numpy(), np.asarray(logs_j["t"]))
    g_den = numpy_tree(g_j)["params"]["denoiser"]
    named = dict(model.denoiser.named_parameters())
    assert all(p.grad is not None for p in named.values())
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), _jax_leaf(g_den, name),
                                   rtol=1e-3, atol=1e-6, err_msg=name)
    assert all(p.grad is None for p in model.codec.parameters())


def test_training_loss_from_the_latent_cache_matches_jax(monkeypatch):
    """A batch carrying (latent_mu, latent_logvar) is drawn from instead of
    encoded: loss and per-sample losses against JAX, t weights applied."""
    from raggesture_tpu.models import architecture as JA
    from raggesture_tpu_torch.models.architecture import training_loss

    jcfg, jmodel, params, batch = _tiny()
    qm = _parity_masks(monkeypatch, jcfg, 2)
    jp = _jax_params(params)
    mu, lv = jmodel.apply(jp, batch, method=jmodel.encode_motion_dist)
    cached = dict(batch, latent_mu=np.asarray(mu), latent_logvar=np.asarray(lv))
    tw = np.asarray([0.5, 2.0], np.float32)
    rng = jax.random.PRNGKey(5)
    v_j, logs_j = JA.training_loss(jmodel, jp, jcfg.diffusion_train.schedule(),
                                   cached, rng, t_weights=jnp.asarray(tw),
                                   return_per_sample=True, fused_ctx=True)
    r_enc = jax.random.split(rng, 5)[0]
    draws = _jax_draws(rng, jcfg, 2)
    draws["enc_eps"] = t32(jax.random.normal(r_enc, mu.shape))
    model = _port_model(jcfg, params)
    with torch.no_grad():
        loss, logs = training_loss(
            model, model.cfg.diffusion_train.schedule(), _port_batch(cached),
            t_weights=t32(tw), return_per_sample=True, query_masks=qm,
            **draws)
    np.testing.assert_allclose(loss.item(), float(v_j), rtol=1e-5)
    np.testing.assert_allclose(logs["per_sample_loss"].numpy(),
                               np.asarray(logs_j["per_sample_loss"]),
                               rtol=1e-5)


# ------------------------------------------------------------- train step

def test_two_train_steps_match_jax(monkeypatch):
    """make_train_step(fused_ctx=True) with OptimConfig(lr=1e-3,
    total_steps=50), two steps from the same rng: the logs (rtol 1e-4),
    every denoiser parameter after the steps, and the codec bitwise
    unchanged.

    Adam's step is lr * m / (sqrt(v) + 1e-8) per element, about lr
    whatever the gradient's size, so a float32 difference between the two
    frameworks' gradients moves a parameter by ~lr times its relative size:
    atol 1e-6.  Where a gradient is within ~1000x of the float32 noise
    floor of its tensor (below 1e-4 of its largest element at either step,
    ~1 % of the elements) or zero in exact arithmetic
    (``_zero_exact_gradient``), that noise decides the step's size and
    sign in either framework; those elements are held to the bound of lr
    per step instead."""
    from raggesture_tpu.train import loop as JL
    from raggesture_tpu_torch.train.loop import (
        OptimConfig,
        create_train_state,
        make_train_step,
    )

    jcfg, jmodel, params, batch = _tiny()
    qm = _parity_masks(monkeypatch, jcfg, 2)
    sched_j = jcfg.diffusion_train.schedule()
    jstate, tx = JL.create_train_state(jmodel, _jax_params(params),
                                       JL.OptimConfig(lr=1e-3,
                                                      total_steps=50))
    jstep = JL.make_train_step(jmodel, tx, sched_j, fused_ctx=True)
    model = _port_model(jcfg, params)
    codec0 = {k: v.clone() for k, v in model.codec.state_dict().items()}
    state = create_train_state(model, OptimConfig(lr=1e-3, total_steps=50))
    step = make_train_step(model.cfg.diffusion_train.schedule())
    rng = jax.random.PRNGKey(9)    # each step drops one condition
    pb = _port_batch(batch)
    lr, steps = 1e-3, 2
    named = dict(model.denoiser.named_parameters())
    noisy = {n: _zero_exact_gradient(n) | torch.zeros(p.shape, dtype=bool)
             for n, p in named.items()}
    for s in range(steps):
        jstate, jlogs = jstep(jstate, batch, rng)
        logs = step(state, pb, query_masks=qm,
                    **_jax_draws(jax.random.fold_in(rng, s), jcfg, 2))
        for k in ("recon_loss", "mse_unweighted", "grad_norm"):
            np.testing.assert_allclose(logs[k].item(), float(jlogs[k]),
                                       rtol=1e-4, err_msg=f"step {s}: {k}")
        for n, p in named.items():
            g = p.grad.abs()   # exact zeros (unused speaker rows) stay strict
            noisy[n] |= (g > 0) & (g < 1e-4 * g.max())
    assert state.step == steps
    den = numpy_tree(jstate.params)["params"]["denoiser"]
    for name, p in named.items():
        diff = np.abs(p.detach().numpy() - _jax_leaf(den, name))
        mask = noisy[name].numpy()
        assert mask.mean() < 0.05 or _zero_exact_gradient(name), name
        assert diff[~mask].max(initial=0.0) <= 1e-6, name
        assert diff[mask].max(initial=0.0) <= 2 * lr * steps, name
    for k, v in model.codec.state_dict().items():
        assert torch.equal(v, codec0[k]), k
    jc = numpy_tree(jstate.params)["params"]["codec"]
    for name, v in model.codec.named_parameters():
        np.testing.assert_array_equal(v.numpy(), _jax_leaf(jc, name))


def test_val_step_matches_jax(monkeypatch):
    """make_val_step: the training loss's logs without a gradient or an
    update."""
    from raggesture_tpu.train import loop as JL
    from raggesture_tpu_torch.train.loop import (
        OptimConfig,
        create_train_state,
        make_val_step,
    )

    jcfg, jmodel, params, batch = _tiny()
    qm = _parity_masks(monkeypatch, jcfg, 2)
    jstate, _ = JL.create_train_state(jmodel, _jax_params(params),
                                      JL.OptimConfig())
    rng = jax.random.PRNGKey(21)
    want = JL.make_val_step(jmodel, jcfg.diffusion_train.schedule(),
                            fused_ctx=True)(jstate, batch, rng)
    model = _port_model(jcfg, params)
    state = create_train_state(model, OptimConfig())
    got = make_val_step(model.cfg.diffusion_train.schedule())(
        state, _port_batch(batch), query_masks=qm,
        **_jax_draws(rng, jcfg, 2))
    for k in ("recon_loss", "mse_unweighted"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    assert state.step == 0
    assert all(p.grad is None for p in model.parameters())


def test_fused_ctx_with_dropout_raises_value_error():
    """The JAX package asserts (a check that ``python -O`` drops); the port
    raises."""
    import dataclasses

    from raggesture_tpu_torch.models.architecture import (
        create_model,
        training_loss,
    )

    jcfg = _tiny()[0]
    cfg = port_arch_config(jcfg)
    cfg = dataclasses.replace(
        cfg, denoiser=dataclasses.replace(cfg.denoiser, dropout=0.1))
    model = create_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="dropout"):
        training_loss(model, cfg.diffusion_train.schedule(),
                      _port_batch(_tiny()[3]),
                      generator=torch.Generator().manual_seed(0))
