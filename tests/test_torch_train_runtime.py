"""The training step's remaining options, the port against the JAX package
on the CPU: the losses, the timestep samplers, the ``fused_codec`` step
(the 4-part encode, at the JAX stacked encode's values), the latent
cache, gradient clipping with AdamW and the sampler's timesteps, the
multi-step loop and the checkpoint manager's exact resume, with injected
draws and with draws from a generator.

Tolerances: the losses float32 on both sides (1e-6); ``sample_np`` and the
samplers' histories exactly (the same numpy arithmetic); the 4-part encode
within 2e-5 of JAX's stacked encode (as tests/test_torch_train.py holds it
against JAX's 4-part encode); the latent cache's values within 1e-5 of
JAX's build; two clipped AdamW steps within 1e-6 of optax on every
parameter but the elements whose gradient is float32 noise or zero in
exact arithmetic (tests/test_torch_train.py's bound, lr per step there);
the multi-step loop and the resumed run bitwise equal to the sequential,
uninterrupted run.
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import numpy_tree, port_model_and_jax_tree, t32
from test_torch_train import (
    BATCH_KEYS,
    _jax_draws,
    _jax_leaf,
    _jax_params,
    _parity_masks,
    _port_batch,
    _port_model,
    _zero_exact_gradient,
)


@functools.lru_cache(maxsize=None)
def _tiny():
    """JAX's tiny model, random weights made by the port (every
    zero-initialised Linear given values) as a JAX tree, and a batch of
    two: tests/test_torch_train.py's ``_tiny`` without the JAX init."""
    from raggesture_tpu.datasets.fixtures import tiny_arch_config, tiny_batch
    from raggesture_tpu.models import architecture as JA

    jcfg = tiny_arch_config()
    _, params = port_model_and_jax_tree(jcfg, seed=1)
    batch = {k: np.array(v) for k, v in tiny_batch(seed=4, batch=2).items()
             if k in BATCH_KEYS}
    return jcfg, JA.MotionDiffusionModel(jcfg), params, batch

# ------------------------------------------------------------------ losses


def _loss_case(name, rng):
    """(port value, JAX value) of one loss call on the same inputs."""
    from raggesture_tpu.models import losses as J
    from raggesture_tpu_torch.models import losses as P

    a = rng.randn(2, 9, 5).astype(np.float32)
    b = rng.randn(2, 9, 5).astype(np.float32)
    w = rng.rand(2, 9, 5).astype(np.float32)

    def both(fn, *args, **kw):
        return (getattr(P, fn)(*[t32(x) for x in args], **kw).numpy(),
                np.asarray(getattr(J, fn)(*[jnp.asarray(x) for x in args],
                                          **kw)))

    if name == "mse_avg_factor":
        return both("mse_loss", a, b, w, reduction="mean", avg_factor=7.0)
    if name.startswith("mse_"):
        red = name.split("_")[1]
        return both("mse_loss", a, b, w, reduction=red)
    if name.startswith("laplacian_1d"):
        n = int(name[-1])
        return P.laplacian_1d(n).numpy(), np.asarray(J.laplacian_1d(n))
    if name == "laplacian_filter_time":
        return both("laplacian_filter_time", a)
    if name == "laplacian_mse":
        return both("laplacian_mse_loss", a, b, w, reduction="sum")
    cls = {"MSELoss": "MSELoss", "LaplacianMSELoss": "LaplacianMSELoss"}[
        name]
    p = getattr(P, cls)(reduction="sum", loss_weight=0.5)
    j = getattr(J, cls)(reduction="sum", loss_weight=0.5)
    return (p(t32(a), t32(b), t32(w), reduction_override="none").numpy(),
            np.asarray(j(jnp.asarray(a), jnp.asarray(b), jnp.asarray(w),
                         reduction_override="none")))


@pytest.mark.parametrize("name", [
    "mse_none", "mse_mean", "mse_sum", "mse_avg_factor", "laplacian_1d_3",
    "laplacian_1d_5", "laplacian_filter_time", "laplacian_mse", "MSELoss",
    "LaplacianMSELoss"])
def test_losses_match_jax(name):
    got, want = _loss_case(name, np.random.RandomState(0))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_loss_reductions_refuse_what_jax_refuses():
    from raggesture_tpu_torch.models import losses as P

    x = torch.ones(3)
    with pytest.raises(ValueError):
        P.reduce_loss(x, "max")
    with pytest.raises(ValueError):
        P.weight_reduce_loss(x, reduction="sum", avg_factor=2.0)
    with pytest.raises(ValueError):
        P.MSELoss(reduction="max")


# ---------------------------------------------------------------- samplers

def test_samplers_draw_and_update_as_jax():
    """sample_np on equal RandomStates gives JAX's t and weights exactly,
    uniform, during the warm-up and after it; the history and the weights
    after the same updates are equal."""
    from raggesture_tpu.diffusion import samplers as J
    from raggesture_tpu_torch.diffusion import samplers as P

    S = 40
    for name in ("uniform", "loss-second-moment"):
        p, j = P.build_sampler(name, S), J.build_sampler(name, S)
        rp, rj = np.random.RandomState(3), np.random.RandomState(3)
        feed = np.random.RandomState(5)
        for step in range(40):
            tp, wp = p.sample_np(rp, 8)
            tj, wj = j.sample_np(rj, 8)
            assert tp.dtype == tj.dtype and wp.dtype == wj.dtype
            np.testing.assert_array_equal(tp, tj)
            np.testing.assert_array_equal(wp, wj)
            if name == "loss-second-moment":
                ts = feed.randint(0, S, 48)
                losses = (feed.rand(48) * (1 + ts / S)).astype(np.float32)
                p.update_with_losses(torch.from_numpy(ts), t32(losses))
                j.update_with_losses(ts, losses)
        np.testing.assert_array_equal(p.weights(), j.weights())
        if name == "loss-second-moment":
            assert p._warmed_up() and j._warmed_up()
            np.testing.assert_array_equal(p._loss_history, j._loss_history)
            assert not np.allclose(p.weights(), p.weights().mean())
    with pytest.raises(NotImplementedError):
        P.build_sampler("nope", S)


def test_sampler_draws_on_a_torch_generator_and_refuses_several_processes(
        monkeypatch):
    from raggesture_tpu_torch.diffusion import samplers as P

    s = P.LossSecondMomentResampler(10, history_per_term=1)
    s.update_with_losses(np.arange(10), np.linspace(0.1, 1.0, 10))
    g = torch.Generator().manual_seed(0)
    t, w = s.sample(g, 4096)
    assert t.dtype == torch.int64 and w.dtype == torch.float32
    assert t.min() >= 0 and t.max() < 10
    p = s.weights() / s.weights().sum()
    np.testing.assert_allclose(w.numpy(), 1.0 / (10 * p[t.numpy()]),
                               rtol=1e-6)
    # t's frequencies follow the weights (the largest loss most often)
    counts = np.bincount(t.numpy(), minlength=10) / 4096
    np.testing.assert_allclose(counts, p, atol=0.03)
    # across processes the synced update takes every rank's pairs from the
    # gather (here a stand-in that returns this rank's pairs twice; the
    # real two-process gather: test_torch_distributed.py), the unsynced
    # one its own
    from raggesture_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "all_gather_ragged",
                        lambda arrays: [np.concatenate([a, a])
                                        for a in arrays])
    synced = P.LossSecondMomentResampler(10, history_per_term=2)
    synced.update_with_losses([1], [0.5])
    assert synced._loss_counts[1] == 2
    own = P.LossSecondMomentResampler(10, history_per_term=2, synced=False)
    own.update_with_losses([1], [0.5])
    assert own._loss_counts[1] == 1


# ------------------------------------------------------------- fused_codec

def test_fused_codec_step_takes_the_four_part_encode_at_jaxs_values():
    """``make_train_step(fused_codec=True)`` is the 4-part step bitwise (the
    port keeps the flag for the JAX signature only), and the 4-part encode
    it runs is within 2e-5 of the JAX package's stacked 3-part encode, so
    the flag's results stay the JAX package's."""
    from raggesture_tpu.models.codec import part_features as jax_features
    from raggesture_tpu.models.fused_codec import (
        fused_encode_dist as jax_fused,
    )
    from raggesture_tpu.models.fused_codec import (
        stack_codec_params as jax_stack,
    )
    from raggesture_tpu_torch.train.loop import make_train_step

    jcfg, _, params, batch = _tiny()
    model = _port_model(jcfg, params)
    pb = _port_batch(batch)
    mask = batch["motion_mask"].copy()
    mask[1, 20:] = 0.0
    pb["motion_mask"] = t32(mask)
    mu, lv = model.codec.encode_dist(model._part_features(pb),
                                     pb["motion_mask"])
    cp = _jax_params(params)["params"]["codec"]
    keys = ("motion_upper", "motion_lower", "motion_face", "motion_hands",
            "trans", "facial", "contact")
    jf = jax_features(*(jnp.asarray(batch[k]) for k in keys))
    mu_j, lv_j = jax.jit(lambda c, f, m: jax_fused(
        jcfg.codec, c, jax_stack(c, jcfg.codec), f, m))(cp, jf,
                                                        jnp.asarray(mask))
    rows = [i for i in range(mu.shape[1]) if lv[0, i, 0] > -1e29]
    assert len(rows) == mu.shape[1] - 3
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), atol=2e-5)
    np.testing.assert_allclose(lv[:, rows].numpy(),
                               np.asarray(lv_j)[:, rows], atol=2e-5)

    draws = _jax_draws(jax.random.PRNGKey(2), jcfg, 2)
    stacked, four = _fresh_state(), _fresh_state()
    sched = stacked.model.cfg.diffusion_train.schedule()
    la = make_train_step(sched, fused_codec=True)(stacked, pb, **draws)
    lb = make_train_step(sched)(four, pb, **draws)
    for k in lb:
        assert torch.equal(la[k], lb[k]), k
    _assert_states_equal(stacked, four)


# ------------------------------------------------------------ latent cache

class _Windows:
    """A window dataset of ``n`` records (the collate schema)."""

    def __init__(self, n, seed=0):
        from raggesture_tpu.datasets.fixtures import tiny_batch

        b = tiny_batch(seed=seed, batch=n)
        keys = ("motion_upper", "motion_lower", "motion_face",
                "motion_hands", "trans", "facial", "contact", "motion_mask")
        self.records = [dict({k: np.array(b[k][i]) for k in keys},
                             speaker_id=np.asarray([1]),
                             sample_name=f"clip_{i}/0") for i in range(n)]

    def __len__(self):
        return len(self.records)

    def __getitem__(self, i):
        return self.records[i]


def test_latent_cache_files_and_values_match_jax(tmp_path, monkeypatch):
    from raggesture_tpu.datasets import latent_cache as J
    from raggesture_tpu_torch.datasets import latent_cache as P

    jcfg, jmodel, params, _ = _tiny()
    model = _port_model(jcfg, params)
    ds = _Windows(5)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    P.build_latent_cache(ds, model, port_dir, batch_size=2)
    J.build_latent_cache(ds, jmodel, _jax_params(params), jax_dir,
                         batch_size=2)
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir)) == [
        "index.json", "latents_00000.npz"]
    with open(os.path.join(port_dir, "index.json")) as f:
        ip = json.load(f)
    with open(os.path.join(jax_dir, "index.json")) as f:
        ij = json.load(f)
    assert sorted(ip) == sorted(ij) == ["fingerprint", "names", "shard_size"]
    assert ip["names"] == ij["names"] and ip["shard_size"] == 1024
    with np.load(os.path.join(port_dir, "latents_00000.npz")) as zp, \
            np.load(os.path.join(jax_dir, "latents_00000.npz")) as zj:
        assert sorted(zp.files) == sorted(zj.files) == ["logvar", "mu"]
        for k in ("mu", "logvar"):
            assert zp[k].dtype == zj[k].dtype == np.float32
            np.testing.assert_allclose(zp[k], zj[k], rtol=1e-5, atol=1e-5)
    # each package reads the other's cache (fingerprints differ: None)
    port_reads_jax = P.LatentCachedDataset(ds, jax_dir)
    jax_reads_port = J.LatentCachedDataset(ds, port_dir)
    for i in range(len(ds)):
        for k in ("latent_mu", "latent_logvar"):
            np.testing.assert_allclose(port_reads_jax[i][k],
                                       jax_reads_port[i][k], rtol=1e-5,
                                       atol=1e-5)
    assert port_reads_jax.records is ds.records        # delegated
    # the port's own check, and a kept cache
    P.LatentCachedDataset(ds, port_dir, params=model)
    assert P.build_latent_cache(ds, model, port_dir) == port_dir
    with pytest.raises(RuntimeError, match="different codec"):
        P.LatentCachedDataset(ds, jax_dir, params=model)
    with pytest.raises(RuntimeError, match="different codec"):
        P.build_latent_cache(ds, model, jax_dir)
    P.build_latent_cache(ds, model, jax_dir, overwrite=True)
    # SHARD windows a shard, read back by both readers
    monkeypatch.setattr(P, "SHARD", 2)
    many = str(tmp_path / "many")
    P.build_latent_cache(ds, model, many, batch_size=2)
    assert sorted(f for f in os.listdir(many) if f.endswith(".npz")) == [
        f"latents_{i:05d}.npz" for i in range(3)]
    one = P.LatentCachedDataset(ds, port_dir)
    for reader in (P.LatentCachedDataset(ds, many),
                   J.LatentCachedDataset(ds, many)):
        for i in range(len(ds)):
            for k in ("latent_mu", "latent_logvar"):
                np.testing.assert_array_equal(reader[i][k], one[i][k])


# -------------------------------------------------- clip, AdamW, timesteps

@pytest.fixture(scope="module")
def clipped_steps():
    """Two steps of optax (clip_by_global_norm + adamw, the sampler's
    timesteps and weights) and of the port, from the same weights and
    draws; the clip is half the first step's gradient norm, so it acts."""
    from raggesture_tpu.diffusion.samplers import LossSecondMomentResampler
    from raggesture_tpu.models import architecture as JA
    from raggesture_tpu.train import loop as JL
    from raggesture_tpu_torch.models.architecture import training_loss
    from raggesture_tpu_torch.train.loop import (
        OptimConfig,
        create_train_state,
        global_norm,
        make_train_step,
    )

    jcfg, jmodel, params, batch = _tiny()
    mp = pytest.MonkeyPatch()
    qm = _parity_masks(mp, jcfg, 2)
    model = _port_model(jcfg, params)
    sched = model.cfg.diffusion_train.schedule()
    rng = jax.random.PRNGKey(9)
    loss, _ = training_loss(model, sched, _port_batch(batch), query_masks=qm,
                            **_jax_draws(jax.random.fold_in(rng, 0), jcfg, 2))
    loss.backward()
    clip = 0.5 * global_norm([p.grad for p in model.denoiser.parameters()
                              if p.grad is not None]).item()
    model.denoiser.zero_grad(set_to_none=True)
    kw = dict(lr=1e-3, total_steps=50, grad_clip=clip, weight_decay=0.01)
    jstate, tx = JL.create_train_state(jmodel, _jax_params(params),
                                       JL.OptimConfig(**kw))
    jstep = JL.make_train_step(jmodel, tx, jcfg.diffusion_train.schedule(),
                               with_timesteps=True, fused_ctx=True)
    state = create_train_state(model, OptimConfig(**kw))
    assert isinstance(state.optimizer, torch.optim.AdamW)
    step = make_train_step(sched, with_timesteps=True)
    sampler = LossSecondMomentResampler(jcfg.diffusion_train.diffusion_steps,
                                        history_per_term=1)
    sampler.update_with_losses(
        np.arange(sampler.num_timesteps),
        np.random.RandomState(0).rand(sampler.num_timesteps))
    np_rng = np.random.RandomState(4)
    named = dict(model.denoiser.named_parameters())
    noisy = {n: _zero_exact_gradient(n) | torch.zeros(p.shape, dtype=bool)
             for n, p in named.items()}
    logs, jlogs = [], []
    for s in range(2):
        t, tw = sampler.sample_np(np_rng, 2)
        jstate, jl = jstep(jstate, batch, rng, jnp.asarray(t),
                           jnp.asarray(tw))
        draws = _jax_draws(jax.random.fold_in(rng, s), jcfg, 2)
        draws.update(t=torch.from_numpy(t).long(), t_weights=t32(tw))
        logs.append(step(state, _port_batch(batch), query_masks=qm, **draws))
        jlogs.append({k: np.asarray(v) for k, v in jl.items()})
        for n, p in named.items():
            g = p.grad.abs()
            noisy[n] |= (g > 0) & (g < 1e-4 * g.max())
    mp.undo()
    return dict(model=model, state=state, jstate=jstate, logs=logs,
                jlogs=jlogs, noisy=noisy, clip=clip, lr=kw["lr"])


def test_clipped_adamw_steps_match_optax(clipped_steps):
    """The optax rule (scale by clip / norm only at or above the clip),
    AdamW's decoupled decay over the denoiser, the codec untouched: every
    denoiser parameter after two steps within 1e-6."""
    c = clipped_steps
    for logs, jl in zip(c["logs"], c["jlogs"]):
        assert jl["grad_norm"] > c["clip"]           # the clip acted
        for k in ("recon_loss", "mse_unweighted", "grad_norm"):
            np.testing.assert_allclose(logs[k].item(), float(jl[k]),
                                       rtol=1e-4, err_msg=k)
    den = numpy_tree(c["jstate"].params)["params"]["denoiser"]
    for name, p in c["model"].denoiser.named_parameters():
        diff = np.abs(p.detach().numpy() - _jax_leaf(den, name))
        mask = c["noisy"][name].numpy()
        assert mask.mean() < 0.05 or _zero_exact_gradient(name), name
        assert diff[~mask].max(initial=0.0) <= 1e-6, name
        assert diff[mask].max(initial=0.0) <= 2 * c["lr"] * 2, name
    jc = numpy_tree(c["jstate"].params)["params"]["codec"]
    for name, v in c["model"].codec.named_parameters():
        np.testing.assert_array_equal(v.numpy(), _jax_leaf(jc, name))


def test_sampler_timesteps_and_per_sample_losses_match_jax(clipped_steps):
    """with_timesteps: the sampler's t come back in the logs with the
    per-sample losses (weighted into the loss by the sampler's weights)."""
    for logs, jl in zip(clipped_steps["logs"], clipped_steps["jlogs"]):
        np.testing.assert_array_equal(logs["t"].numpy(), jl["t"])
        np.testing.assert_allclose(logs["per_sample_loss"].numpy(),
                                   jl["per_sample_loss"], rtol=1e-5)


def test_clip_is_the_optax_rule_not_torchs():
    """Below the clip the gradients stay bitwise; at and above it they are
    (g / norm) * clip, with no epsilon."""
    from raggesture_tpu_torch.train.loop import (
        clip_by_global_norm_,
        global_norm,
    )

    g = [torch.tensor([3.0, 0.0]), torch.tensor([4.0])]
    norm = global_norm(g)
    kept = [x.clone() for x in g]
    clip_by_global_norm_(kept, norm, 5.0 + 1e-6)
    assert all(torch.equal(a, b) for a, b in zip(kept, g))
    clip_by_global_norm_(g, norm, 2.5)
    assert torch.equal(g[0], torch.tensor([3.0, 0.0]) / norm * 2.5)
    assert torch.equal(g[1], torch.tensor([4.0]) / norm * 2.5)


# ------------------------------------------------- multi-step and resume

def _fresh_state(**kw):
    from raggesture_tpu_torch.train.loop import OptimConfig, create_train_state

    jcfg, _, params, _ = _tiny()
    return create_train_state(_port_model(jcfg, params),
                              OptimConfig(lr=1e-3, total_steps=20, **kw))


def _step_draws(k, B=2):
    jcfg = _tiny()[0]
    return [_jax_draws(jax.random.PRNGKey(100 + i), jcfg, B)
            for i in range(k)]


def _assert_states_equal(a, b):
    for (n, p), q in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(p, q), n
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(sb["state"][i][k])), (i, k)
    assert a.step == b.step


def test_multi_step_equals_sequential_steps_bitwise():
    from raggesture_tpu_torch.train.loop import (
        make_multi_train_step,
        make_train_step,
    )

    batch = _port_batch(_tiny()[3])
    draws = _step_draws(3)
    seq, multi = _fresh_state(grad_clip=1.0), _fresh_state(grad_clip=1.0)
    sched = seq.model.cfg.diffusion_train.schedule()
    step = make_train_step(sched, log_per_sample=True)
    seq_logs = [step(seq, batch, **d) for d in draws]
    stacked = {k: torch.stack([batch[k]] * 3) for k in batch}
    stacked_draws = {
        "enc_eps": {p: torch.stack([d["enc_eps"][p] for d in draws])
                    for p in draws[0]["enc_eps"]},
        **{k: torch.stack([d[k] for d in draws])
           for k in ("t", "noise", "cond_mask")}}
    logs = make_multi_train_step(sched, log_per_sample=True)(
        multi, stacked, **stacked_draws)
    assert logs["recon_loss"].shape == (3,) and "t" not in logs
    for k in seq_logs[0]:
        assert torch.equal(logs[k], torch.stack([l[k] for l in seq_logs])), k
    _assert_states_equal(seq, multi)
    # draws from a generator, in the same order
    a, b = _fresh_state(), _fresh_state()
    ga, gb = (torch.Generator().manual_seed(6) for _ in range(2))
    for _ in range(2):
        step(a, batch, ga)
    make_multi_train_step(sched, log_per_sample=True)(
        b, {k: torch.stack([batch[k]] * 2) for k in batch}, gb)
    _assert_states_equal(a, b)


def test_resume_takes_the_next_step_bitwise(tmp_path):
    """A run restored at step 2 takes step 3 bitwise equal to the
    uninterrupted run: parameters, Adam(W) moments and step counts, the
    cosine step, the meta."""
    from raggesture_tpu_torch.train.checkpoint import CheckpointManager
    from raggesture_tpu_torch.train.loop import make_train_step

    batch = _port_batch(_tiny()[3])
    draws = _step_draws(3)
    run = _fresh_state(weight_decay=0.01)
    step = make_train_step(run.model.cfg.diffusion_train.schedule())
    mgr = CheckpointManager(str(tmp_path), interval=2, max_to_keep=2)
    for e, d in enumerate(draws[:2]):
        step(run, batch, **d)
        saved = mgr.maybe_save(e, run, {"config": "tiny"})
        assert saved == (e == 1)
    assert mgr.latest_epoch() == 1
    want = step(run, batch, **draws[2])
    resumed = _fresh_state(weight_decay=0.01)
    resumed, meta = CheckpointManager(str(tmp_path)).restore(resumed)
    assert meta == {"config": "tiny", "epoch": 1} and resumed.step == 2
    got = step(resumed, batch, **draws[2])
    for k in want:
        assert torch.equal(got[k], want[k]), k
    _assert_states_equal(resumed, run)


def test_resume_restores_the_generator_the_steps_draw_from(tmp_path):
    """A run whose steps draw from a torch generator: restored at step 2
    with the generator's saved state, step 3 takes the uninterrupted run's
    draws, bitwise.  A generator only reseeded takes step 0's draws again
    and differs; a checkpoint saved without a generator refuses one."""
    from raggesture_tpu_torch.train.checkpoint import CheckpointManager
    from raggesture_tpu_torch.train.loop import make_train_step

    batch = _port_batch(_tiny()[3])
    run = _fresh_state()
    step = make_train_step(run.model.cfg.diffusion_train.schedule(),
                           with_timesteps=True)
    g = torch.Generator().manual_seed(9)
    mgr = CheckpointManager(str(tmp_path / "a"), interval=2)
    for e in range(2):
        step(run, batch, g)
        mgr.maybe_save(e, run, generator=g)
    want = step(run, batch, g)

    resumed, g2 = _fresh_state(), torch.Generator().manual_seed(9)
    CheckpointManager(str(tmp_path / "a")).restore(resumed, generator=g2)
    got = step(resumed, batch, g2)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    _assert_states_equal(resumed, run)

    reseeded = _fresh_state()
    CheckpointManager(str(tmp_path / "a")).restore(reseeded)
    again = step(reseeded, batch, torch.Generator().manual_seed(9))
    assert not torch.equal(again["t"], want["t"])

    bare = CheckpointManager(str(tmp_path / "b"), interval=1)
    bare.save(0, run)
    with pytest.raises(ValueError, match="no generator state"):
        bare.restore(_fresh_state(), generator=torch.Generator())


def test_checkpoint_manager_keeps_and_refuses_as_jax(tmp_path):
    from raggesture_tpu_torch.train.checkpoint import CheckpointManager

    state = _fresh_state()
    mgr = CheckpointManager(str(tmp_path), interval=1, max_to_keep=2)
    for e in range(4):
        mgr.save(e, state)
    assert mgr.epochs() == [2, 3]
    mgr.save(3, state)                 # the finished run's re-save: no-op
    mgr.save(2, state)                 # saved by this manager: no-op
    other = CheckpointManager(str(tmp_path))
    with pytest.raises(RuntimeError, match="earlier run"):
        other.save(0, state)
    other.save(3, state)
    other.save(4, state)
    assert other.epochs() == [2, 3, 4]
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(state)
