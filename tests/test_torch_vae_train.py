"""Part-VAE training in the port (``models/vae_architecture.py``,
``python -m raggesture_tpu_torch.tools.train_vae``), the VAE variants the
JAX package builds (``models/vae.py``), and kernel K2 under autograd
(``ops/mha.py::SoftmaxMHA``), against the JAX package on the same weights
and draws.

The VAE is the tiny config's part VAE (latent 32, 2 layers); the batch's
second window is half padded, so the frame mask reaches the encoder.
Tolerances: losses 1e-5 relative, forwards 1e-5 of the output's scale;
after three Adam steps of lr 1e-3 the parameters within 1e-5 of the
largest parameter (a bias that starts at zero holds only its updates, so
its own scale is lr-sized), but where a gradient element is within 1e-4 of
its tensor's largest or zero in exact arithmetic (the key projections'
biases: a softmax over keys ignores a shift common to them), whose
rounding noise Adam turns into a step of ~lr: those within two lr a step.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import jax_tree_from_port, numpy_tree, t32

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "configs/raggesture_beatx/tiny_smoke.py")


def _vcfg(part="upper", **kw):
    from raggesture_tpu.datasets.fixtures import tiny_arch_config

    return dataclasses.replace(tiny_arch_config().codec.vae_config(part), **kw)


def _port_cfg(jv):
    from raggesture_tpu_torch.models.vae import VAEConfig

    return VAEConfig(**dataclasses.asdict(jv))


def _batch(seed=4, B=2):
    from raggesture_tpu.datasets.fixtures import tiny_batch

    b = {k: np.array(v, np.float32) for k, v in
         tiny_batch(seed=seed, batch=B).items()}
    b["motion_mask"][1, 15:] = 0.0
    return b


def _port_vae(jv, seed=0):
    from raggesture_tpu_torch.tools.train_vae import build_vae

    return build_vae(_port_cfg(jv), torch.device("cpu"), seed)


def _close(got, want, rel=1e-5):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rel * scale, (
        float(np.abs(got - want).max()), scale)


# ------------------------------------------------------------- K2, autograd

@pytest.mark.parametrize("heads,width", [(32, 512), (64, 512), (4, 24)])
def test_k2_autograd_function_gives_the_plain_gradients(heads, width):
    """``SoftmaxMHA`` on the CPU (forward and recomputed backward of the
    plain version): the output and q, k, v gradients equal autograd
    through ``softmax_mha_reference``, bitwise, at the decoders' 32 heads
    of 16 and 64 of 8, and at Tq != Tk (the encoder_decoder cross
    attention)."""
    from raggesture_tpu_torch.ops.mha import (
        SoftmaxMHA,
        fused_softmax_mha,
        softmax_mha_reference,
    )

    g = torch.Generator().manual_seed(heads)
    q = torch.randn(2, 13, width, generator=g, requires_grad=True)
    k = torch.randn(2, 5, width, generator=g, requires_grad=True)
    v = torch.randn(2, 5, width, generator=g, requires_grad=True)
    up = torch.randn(2, 13, width, generator=g)
    scale = 1.0 / np.sqrt(width // heads)
    before = SoftmaxMHA.backwards
    out = fused_softmax_mha(q, k, v, heads, scale)
    got = torch.autograd.grad(out, (q, k, v), up)
    assert SoftmaxMHA.backwards == before + 1
    ref = softmax_mha_reference(q, k, v, heads, scale)
    want = torch.autograd.grad(ref, (q, k, v), up)
    assert torch.equal(out, ref)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with torch.no_grad():
        assert torch.equal(fused_softmax_mha(q, k, v, heads, scale), ref)


# --------------------------------------------------------------- variants

VARIANTS = {
    "shipped": {},
    "normalize_before": dict(normalize_before=True),
    "relu": dict(activation="relu"),
    "sine": dict(position_embedding="sine"),
    "encoder_decoder": dict(decoder_arch="encoder_decoder"),
    "all_options": dict(decoder_arch="encoder_decoder", normalize_before=True,
                        activation="relu", position_embedding="sine"),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_vae_variant_matches_jax(name):
    """Each VAE variant the JAX package builds: the port's random weights
    through ``jax_tree_from_port`` into JAX and back through
    ``load_jax_params`` (every leaf used, every parameter filled), then the
    masked encode's (mu, logvar) and the decode against JAX's."""
    from raggesture_tpu.models.vae import TransformerVAE as JaxVAE

    from raggesture_tpu_torch.models.vae_architecture import (
        part_batch_features,
    )
    from raggesture_tpu_torch.utils.convert_jax import load_jax_params

    jv = _vcfg(**VARIANTS[name])
    vae = _port_vae(jv, seed=3)
    tree = jax_tree_from_port(vae)
    again = _port_vae(jv, seed=9)
    load_jax_params(again, tree)
    for k, v in vae.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k
    b = _batch()
    feats = part_batch_features({k: t32(v) for k, v in b.items()}, "upper")
    mask = t32(b["motion_mask"])
    jvae = JaxVAE(jv)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    mu_j, lv_j = jvae.apply(jp, jnp.asarray(feats.numpy()),
                            jnp.asarray(b["motion_mask"]),
                            method=jvae.encode_dist)
    with torch.no_grad():
        mu, lv = vae.encode_dist(feats, mask)
        z = mu + 0.3 * torch.randn(mu.shape, generator=torch.Generator()
                                   .manual_seed(1))
        rec = vae.decode(z, 30)
    rec_j = jvae.apply(jp, jnp.asarray(z.numpy()), 30, method=jvae.decode)
    _close(mu.numpy(), mu_j)
    _close(lv.numpy(), lv_j)
    _close(rec.numpy(), rec_j)
    assert hasattr(vae, "mem_pos_decoder") == (
        jv.decoder_arch == "encoder_decoder")
    assert ("pe" in dict(vae.query_pos_encoder.named_parameters())) == (
        jv.position_embedding == "learned")


def test_vae_dropout_comes_from_explicit_draws():
    """``drop`` given: the same draws give the same decode, other draws
    another, and without it the decode is deterministic; a codec of a
    variant decodes part by part in StagedGenerator, not as the stack."""
    from raggesture_tpu.datasets.fixtures import tiny_arch_config

    from raggesture_tpu_torch.models.fused_codec import stackable
    from raggesture_tpu_torch.models.layers import DropoutDraws
    from test_torch_common import port_arch_config

    vae = _port_vae(_vcfg(decoder_arch="encoder_decoder",
                          normalize_before=True))
    z = torch.randn(2, 2, 32, generator=torch.Generator().manual_seed(0))

    def dec(seed):
        with torch.no_grad():
            return vae.decode(z, 30, drop=None if seed is None else
                              DropoutDraws(torch.Generator().manual_seed(seed)))

    assert torch.equal(dec(1), dec(1)) and not torch.equal(dec(1), dec(2))
    assert not torch.equal(dec(1), dec(None))
    assert torch.equal(dec(None), dec(None))
    cfg = port_arch_config(tiny_arch_config())
    assert stackable(cfg.codec)
    assert not stackable(dataclasses.replace(cfg.codec,
                                             position_embedding="sine"))


# ------------------------------------------------------------- the losses

def test_kl_and_vae_training_loss_match_jax():
    """``kl_divergence`` and ``vae_training_loss`` (reconstruction,
    velocity, KL; the frame mask through the encoder) with JAX's draw."""
    from raggesture_tpu.models import vae_architecture as JV
    from raggesture_tpu.models.vae import TransformerVAE as JaxVAE

    from raggesture_tpu_torch.models import vae_architecture as PV

    mu = np.random.RandomState(0).randn(3, 4, 8).astype(np.float32)
    lv = np.random.RandomState(1).randn(3, 4, 8).astype(np.float32) * 0.3
    np.testing.assert_allclose(
        PV.kl_divergence(t32(mu), t32(lv)).item(),
        float(JV.kl_divergence(jnp.asarray(mu), jnp.asarray(lv))), rtol=1e-5)
    jv = _vcfg("lowertrans")
    vae = _port_vae(jv, seed=2)
    tree = jax_tree_from_port(vae)
    b = _batch()
    feats_j = JV.part_batch_features(b, "lowertrans")
    rng = jax.random.PRNGKey(7)
    cfg_j = JV.VAETrainConfig(part="lowertrans", kl_weight=1e-2)
    loss_j, logs_j = JV.vae_training_loss(
        JaxVAE(jv), jax.tree_util.tree_map(jnp.asarray, tree), feats_j,
        jnp.asarray(b["motion_mask"]), rng, cfg_j)
    eps = t32(jax.random.normal(rng, (2, 2, 32)))
    feats = PV.part_batch_features({k: t32(v) for k, v in b.items()},
                                   "lowertrans")
    _close(feats.numpy(), feats_j)
    loss, logs = PV.vae_training_loss(
        vae, feats, t32(b["motion_mask"]), eps,
        PV.VAETrainConfig(part="lowertrans", kl_weight=1e-2))
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    for k in ("recon", "vel", "kl"):
        np.testing.assert_allclose(logs[k].item(), float(logs_j[k]),
                                   rtol=1e-5, err_msg=k)


def test_three_train_steps_match_jax():
    """``make_vae_train_step`` from JAX's init (encode and decode inits
    merged, as the JAX tool does), carried over with ``load_jax_params``,
    three steps of Adam with the tool's cosine schedule and JAX's draws
    (``fold_in(PRNGKey(seed), step)``): the logs and every parameter."""
    import optax

    from raggesture_tpu.models import vae_architecture as JV
    from raggesture_tpu.models.vae import TransformerVAE as JaxVAE

    from raggesture_tpu_torch.models import vae_architecture as PV
    from raggesture_tpu_torch.utils.convert_jax import load_jax_params

    jv = _vcfg("upper")
    jvae = JaxVAE(jv)
    b = _batch()
    feats = JV.part_batch_features(b, "upper")
    p = jvae.init({"params": jax.random.PRNGKey(0),
                   "vae": jax.random.PRNGKey(1)}, feats[:1], sample=False,
                  method=jvae.encode_to_dist)
    d = jvae.init({"params": jax.random.PRNGKey(0)},
                  jnp.zeros((1, 2, jv.latent_dim)), method=jvae.decode)
    params = {"params": {**d["params"], **p["params"]}}
    lr, total = 1e-3, 10
    tx = optax.adam(optax.cosine_decay_schedule(lr, total, alpha=1e-6))
    opt_state = tx.init(params)
    cfg = JV.VAETrainConfig(part="upper")
    jstep = jax.jit(JV.make_vae_train_step(jvae, tx, cfg, "upper"))
    vae = _port_vae(jv, seed=5)
    load_jax_params(vae, numpy_tree(params))
    opt = torch.optim.Adam(vae.parameters(), lr=lr, eps=1e-8)
    step = PV.make_vae_train_step(vae, opt, PV.VAETrainConfig(part="upper"),
                                  "upper", PV.cosine_decay(lr, total, 1e-6))
    pb = {k: t32(v) for k, v in b.items()}
    rng = jax.random.PRNGKey(3)
    noisy = {}
    for s in range(3):
        params, opt_state, logs_j = jstep(params, opt_state, b, rng,
                                          jnp.asarray(s))
        eps = t32(jax.random.normal(jax.random.fold_in(rng, s), (2, 2, 32)))
        logs = step(pb, s, eps=eps)
        for k in ("loss", "recon", "vel", "kl"):
            np.testing.assert_allclose(logs[k].item(), float(logs_j[k]),
                                       rtol=1e-5, err_msg=f"step {s} {k}")
        for n, q in vae.named_parameters():
            gr = q.grad.abs()
            noisy[n] = noisy.get(n, n.endswith("k_proj.bias")) | (
                gr < 1e-4 * gr.max())
    want = PV_state(params)
    scale = max(float(np.abs(w).max()) for w in want.values())
    for n, q in vae.named_parameters():
        diff = np.abs(q.detach().numpy() - want[n])
        quiet = ~np.broadcast_to(np.asarray(noisy[n]), diff.shape)
        assert diff[quiet].max(initial=0.0) <= 1e-5 * scale, n
        assert diff.max() <= 2 * lr * 3, n


def PV_state(params):
    """A JAX VAE tree as {port parameter name: numpy array}."""
    from raggesture_tpu_torch.utils.convert_jax import load_jax_params

    jv = _vcfg("upper")
    vae = _port_vae(jv, seed=6)
    load_jax_params(vae, numpy_tree(params))
    return {n: p.detach().numpy() for n, p in vae.named_parameters()}


# ------------------------------------------------------------- the tool

@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    from test_dataset_build import make_raw_beat2

    ws = str(tmp_path_factory.mktemp("ws"))
    root = os.path.join(ws, "beat2")
    make_raw_beat2(root, [("2_scott_0_1_1", "train"),
                          ("2_scott_0_2_2", "train")], n_sec=12)
    opts = [f"data.{s}.{k}={v}" for s in ("train", "val", "test")
            for k, v in (("data_path", root),
                         ("cache_path", os.path.join(ws, "cache")),
                         ("allow_fake_contacts", True))]
    return ws, opts


@pytest.mark.parametrize("part", ["upper", "lowertrans"])
def test_tool_trains_a_part_that_load_codec_params_grafts(workspace, part):
    """One epoch with ``--device cpu``: the log, metrics.jsonl (a row at the
    epoch's last step), the part's file, which ``load_codec_params``
    grafts into the tiny model strictly and a decode then reads."""
    import json

    from raggesture_tpu_torch.builders import build_architecture
    from raggesture_tpu_torch.config import Config
    from raggesture_tpu_torch.tools.train_vae import main
    from raggesture_tpu_torch.train.checkpoint import load_codec_params

    ws, opts = workspace
    wd = os.path.join(ws, f"vae_{part}")
    stats = main([CFG, "--part", part, "--epochs", "1", "--batch-size", "4",
                  "--work-dir", wd, "--device", "cpu", "--options", *opts])
    assert sorted(os.listdir(wd)) == sorted([
        f"{part}.pt", f"{part}.pt.meta.json", "metrics.jsonl",
        "train_vae.log"])
    assert stats["steps"] == 4 and stats["param_devices"] == ["cpu"]
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        rows = [json.loads(l) for l in f]
    assert [r["step"] for r in rows] == [4]
    assert all(np.isfinite(rows[0][k]) for k in ("loss", "recon", "vel",
                                                 "kl"))
    cfg = Config.fromfile(CFG)
    model = build_architecture(cfg.model, device="cpu", seed=1)
    assert load_codec_params(model, {f"{part}_ckpt": stats["params_path"]}) \
        == [part]
    saved = torch.load(stats["params_path"], weights_only=True)
    for k, v in getattr(model.codec, f"{part}_vae").state_dict().items():
        assert torch.equal(v, saved[k]), k
    with torch.no_grad():
        out = model.decode_latents(torch.randn(1, 11, 32))
    assert all(torch.isfinite(v).all() for v in out.values())


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is "
                    "present: the default device is the card")
def test_tool_without_a_card_or_device_cpu_exits_nonzero(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "raggesture_tpu_torch.tools.train_vae", CFG,
         "--work-dir", str(tmp_path / "w")], cwd=REPO, capture_output=True,
        text=True, timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not os.path.exists(tmp_path / "w")
