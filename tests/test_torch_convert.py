"""The reference's torch checkpoints onto the port
(``utils/convert_torch.py``: ``convert_vae``, ``convert_denoiser``,
``convert_release``, ``assert_tree_matches``; ``tools/convert_weights.py``)
against the JAX package's converters and tool.

  * at the release's names and shapes (``tests/fixtures/golden_keys_*``):
    the port's ``convert_release`` equals ``load_jax_params`` of JAX's
    ``convert_release`` bit for bit, every key read but the documented
    buffers.  The values are float16 (exact in float32 and back), views of
    one random pool, so the 316 M-element state costs no memory of its own;
  * a tiny VAE's encode and decode and a tiny denoiser's call on the port's
    conversion against JAX's modules on JAX's conversion: within 1e-5;
  * strictness on a dropped, an extra and a mis-shaped key;
  * the tool against ``tools/convert_weights.py`` on one release directory:
    the same parts found and the same meta; its files load strictly into
    the model (``load_params``, as the serving tool reads them),
    ``load_codec_params`` and the evaluation tool's FGD loader.

~25 s on one worker.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures")
TOL = 1e-5


def _fix(name):
    with open(os.path.join(FIX, name)) as f:
        return json.load(f)


def _pool_state(shapes, seed=0):
    """{key: float16 view of a shared random pool, at a random offset}."""
    r = np.random.RandomState(seed)
    biggest = max(int(np.prod(s)) for s in shapes.values())
    pool = r.randn(biggest + (1 << 20)).astype(np.float16)
    out = {}
    for k, s in shapes.items():
        n = int(np.prod(s))
        off = r.randint(0, pool.size - n + 1)
        out[k] = pool[off:off + n].reshape(s)
    return out


def test_convert_release_at_the_golden_shapes_equals_the_jax_bridge():
    from raggesture_tpu.utils.convert_torch import \
        convert_release as jax_convert_release

    from raggesture_tpu_torch.models.architecture import (
        ArchitectureConfig,
        MotionDiffusionModel,
    )
    from raggesture_tpu_torch.utils.convert_jax import load_jax_params
    from raggesture_tpu_torch.utils.convert_torch import (
        BUFFERS,
        assert_tree_matches,
        convert_release,
    )

    state = _pool_state(_fix("golden_keys_denoiser.json"))
    # the converters raise on any key they leave unread but the buffers:
    # the reference's sinusoidal table and the four VAEs' unused
    # mem_pos_decoder tables (tests/test_convert_golden.py), which the
    # conversion does not need
    buffers = sorted(k for k in state if k.endswith(BUFFERS))
    assert buffers == sorted(
        ["model.sequence_embedding.pe"]
        + [f"model.gesture_rep_encoder.{p}_vae.mem_pos_decoder.pe"
           for p in ("upper", "hands", "face", "lowertrans")])
    ours = convert_release(state)
    assert sorted(convert_release({k: v for k, v in state.items()
                                   if k not in buffers})) == sorted(ours)
    with torch.device("meta"):
        model = MotionDiffusionModel(ArchitectureConfig()).half()
    model = model.to_empty(device="cpu")
    assert_tree_matches(ours, model)
    load_jax_params(model, jax_convert_release(state))
    own = model.state_dict()
    assert sorted(own) == sorted(ours)
    for k, v in ours.items():
        assert torch.equal(own[k], torch.from_numpy(np.ascontiguousarray(v))
                           ), k


@pytest.fixture(scope="module")
def stand_ins():
    sys.path.insert(0, REPO)
    from tests.test_convert import TorchDenoiser, TorchVAE

    torch.manual_seed(3)
    return TorchVAE, TorchDenoiser


def _state(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def test_tiny_vae_forward_matches_jax(stand_ins):
    import jax.numpy as jnp
    from raggesture_tpu.models.vae import TransformerVAE, VAEConfig
    from raggesture_tpu.utils.convert_torch import convert_vae as jax_convert

    from raggesture_tpu_torch.models import vae as PV
    from raggesture_tpu_torch.utils.convert_torch import (convert_vae,
                                                          load_converted)
    from tests.test_convert import D, FF, HEADS, LAYERS

    TorchVAE, _ = stand_ins
    state = _state(TorchVAE(8).eval())
    kw = dict(nfeats=8, latent_dim=D, num_layers=LAYERS, num_heads=HEADS,
              ff_size=FF, dropout=0.0, frame_chunk_size=5, num_frames=10,
              pe_max_len=64)
    jvae = TransformerVAE(VAEConfig(**kw))
    jp = {"params": jax_convert(state, num_layers=LAYERS)}
    pvae = PV.TransformerVAE(PV.VAEConfig(**kw)).eval()
    load_converted(pvae, convert_vae(state, num_layers=LAYERS))
    x = np.random.RandomState(2).randn(2, 10, 8).astype(np.float32)
    _, (mu, logvar) = jvae.apply(jp, jnp.asarray(x), sample=False,
                                 method=jvae.encode_to_dist)
    z = np.random.RandomState(3).randn(2, 2, D).astype(np.float32)
    rec = jvae.apply(jp, jnp.asarray(z), method=jvae.decode)
    with torch.no_grad():
        pmu, plv = pvae.encode_dist(torch.from_numpy(x))
        prec = pvae.decode(torch.from_numpy(z))
    for got, want in ((pmu, mu), (plv, logvar), (prec, rec)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)


def test_tiny_denoiser_forward_matches_jax(stand_ins):
    import jax.numpy as jnp
    from raggesture_tpu.models.denoiser import DenoiserConfig, GestureDenoiser
    from raggesture_tpu.utils.convert_torch import \
        convert_denoiser as jax_convert

    from raggesture_tpu_torch.models import denoiser as PD
    from raggesture_tpu_torch.utils.convert_torch import (convert_denoiser,
                                                          load_converted)
    from test_torch_common import parity_query_masks_np, same_fields
    from tests.test_convert import D, FF, HEADS

    _, TorchDenoiser = stand_ins
    layers = 2
    state = _state(TorchDenoiser(layers=layers, text_dim=24, num_tokens=11,
                                 n_spk=5).eval())
    state["sequence_embedding.pe"] = np.zeros((10, 1, D), np.float32)
    cfg = DenoiserConfig(latent_dim=D, time_embed_dim=4 * D,
                         num_layers=layers, num_heads=HEADS, ff_size=FF,
                         dropout=0.0, text_latent_dim=24, audio_latent_dim=24,
                         num_speakers=5, max_seq_len=10, frame_chunk_size=5)
    jden = GestureDenoiser(cfg)
    jp = {"params": jax_convert(state, num_layers=layers)}
    pden = PD.GestureDenoiser(same_fields(PD.DenoiserConfig, cfg)).eval()
    load_converted(pden, convert_denoiser(state, num_layers=layers))
    r = np.random.RandomState(4)
    B = 2
    x = r.randn(B, cfg.num_tokens, D).astype(np.float32)
    word = r.randn(B, 6, 24).astype(np.float32)
    audio = r.randn(B, 8, 24).astype(np.float32)
    spk, t = np.array([1, 3]), np.array([7, 99])
    mask = np.ones((B, cfg.num_tokens), np.float32)
    mask[:, list(cfg.sep_indices)] = 0.0
    qm = parity_query_masks_np(cfg, B)
    conds = jden.apply(jp, jnp.asarray(word), jnp.asarray(audio),
                       jnp.asarray(spk), method=jden.encode_conditions)
    want = np.asarray(jden.apply(jp, jnp.asarray(x), jnp.asarray(t),
                                 jnp.asarray(mask), conds, qm,
                                 jnp.ones((B, 1, 1))))
    T = torch.from_numpy
    with torch.no_grad():
        pc = pden.encode_conditions(T(word), T(audio), T(spk))
        got = pden(T(x), T(t), T(mask), pc,
                   {k: T(v) for k, v in qm.items()},
                   torch.ones(B, 1, 1)).numpy()
    valid = (mask > 0) & (qm["xf_text"] > 0)
    np.testing.assert_allclose(got[valid], want[valid], atol=TOL, rtol=TOL)


def test_conversion_is_strict(stand_ins):
    from raggesture_tpu_torch.models import vae as PV
    from raggesture_tpu_torch.utils.convert_torch import (
        assert_tree_matches,
        convert_denoiser,
        convert_release,
        convert_vae,
        load_converted,
    )
    from tests.test_convert import D, FF, HEADS, LAYERS

    TorchVAE, TorchDenoiser = stand_ins
    state = _state(TorchVAE(8))
    vae = PV.TransformerVAE(PV.VAEConfig(
        nfeats=8, latent_dim=D, num_layers=LAYERS, num_heads=HEADS,
        ff_size=FF, frame_chunk_size=5, num_frames=10, pe_max_len=64))
    good = convert_vae(state, num_layers=LAYERS)
    assert_tree_matches(good, vae)
    load_converted(vae, good)
    # a key of the checkpoint that nothing reads
    with pytest.raises(KeyError, match="map to nothing"):
        convert_vae(dict(state, **{"encoder.extra.weight": np.ones(2)}),
                    num_layers=LAYERS)
    with pytest.raises(KeyError, match="map to nothing"):
        convert_denoiser(dict(_state(TorchDenoiser(layers=2)),
                              **{"text_post_proj.weight": np.ones(2)}),
                         num_layers=2)
    # a key dropped from the checkpoint
    dropped = {k: v for k, v in state.items() if k != "final_layer.bias"}
    with pytest.raises(KeyError, match="final_layer.bias"):
        convert_vae(dropped, num_layers=LAYERS)
    # a state missing, adding or mis-shaping a parameter of the model
    for bad, what in (
            ({k: v for k, v in good.items() if k != "decoder.middle.norm1.bias"},
             "missing"),
            (dict(good, extra=np.ones(2)), "unexpected"),
            (dict(good, **{"final_layer.bias": np.ones(9, np.float32)}),
             "shape")):
        before = {k: v.clone() for k, v in vae.state_dict().items()}
        with pytest.raises(ValueError, match=what):
            load_converted(vae, bad)
        assert all(torch.equal(v, before[k])
                   for k, v in vae.state_dict().items())
    # a release whose embedded VAE parts are absent
    den = {f"model.{k}": v for k, v in _state(TorchDenoiser(layers=2)).items()}
    with pytest.raises(KeyError, match="no weights for upper"):
        convert_release(den, num_layers=2)


def _write_release(root, TorchVAE, TorchDenoiser):
    """A release directory in the reference's layout from the reference's
    own modules (``write_release_layout``): four per-part VAE runs, the
    mmcv epoch_64.pth with embedded VAEs under "model.", the FGD
    checkpoint."""
    import chip_smoke

    from raggesture_tpu_torch.tools.convert_weights import (
        write_release_layout)

    nfeats = {"upper": 78, "hands": 180, "face": 106, "lowertrans": 61}
    den = {f"model.{k}": v for k, v in
           TorchDenoiser(layers=8, text_dim=24, num_tokens=11,
                         n_spk=5).state_dict().items()}
    vaes = {}
    for part, n in nfeats.items():
        tv = TorchVAE(n, layers=8)
        for pe in ("query_pos_encoder", "query_pos_decoder"):
            getattr(tv, pe).pe = torch.nn.Parameter(torch.randn(1024, 1, 16))
        vaes[part] = tv.state_dict()
        for k, v in vaes[part].items():
            den[f"model.gesture_rep_encoder.{part}_vae.{k}"] = v
    write_release_layout(
        root, den, vaes, {p: {"num_layers": 8, "transformer_activation":
                              "gelu", "latent_dim": 16} for p in vaes},
        chip_smoke.fgd_standin_state())


def test_tool_matches_the_jax_tool_and_its_files_load_strictly(
        stand_ins, tmp_path, monkeypatch):
    import raggesture_tpu.train.checkpoint as JC

    from raggesture_tpu_torch.models.architecture import (ArchitectureConfig,
                                                          create_model)
    from raggesture_tpu_torch.models.codec import CodecConfig
    from raggesture_tpu_torch.models.denoiser import DenoiserConfig
    from raggesture_tpu_torch.tools import convert_weights, evaluate
    from raggesture_tpu_torch.train.checkpoint import (load_codec_params,
                                                       load_params)

    TorchVAE, TorchDenoiser = stand_ins
    root = str(tmp_path)
    _write_release(root, TorchVAE, TorchDenoiser)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import convert_weights as jax_tool

    saved = {}
    monkeypatch.setattr(JC, "save_params", lambda path, params, meta=None:
                        saved.setdefault(os.path.basename(path), meta))
    monkeypatch.setattr(sys, "argv", ["convert_weights.py", "--all",
                                      "--root", root])
    jax_tool.main()
    report = convert_weights.main(["--all", "--root", root])
    vae_dir = os.path.join(root, "experiments", "vae")
    assert report["parts"] == jax_tool.find_vae_ckpts(vae_dir)
    assert sorted(report["parts"]) == ["face", "hands", "lowertrans", "upper"]
    for part, meta in report["meta"].items():
        assert meta == saved[f"{part}.msgpack"], part
        with open(os.path.join(vae_dir, f"{part}.pt.meta.json")) as f:
            assert json.load(f) == meta
    assert len(report["written"]) == 6

    cfg = ArchitectureConfig(
        denoiser=DenoiserConfig(latent_dim=16, time_embed_dim=64,
                                num_layers=8, num_heads=2, ff_size=32,
                                text_latent_dim=24, audio_latent_dim=24,
                                num_speakers=5, max_seq_len=10,
                                frame_chunk_size=5),
        codec=CodecConfig(latent_dim=16, frame_chunk_size=5, num_frames=10,
                          num_layers=8, num_heads=2, lowertrans_num_heads=2,
                          ff_size=32))
    model = create_model(cfg, device="cpu")
    meta = load_params(os.path.join(root, "experiments", "diffusion",
                                    "params.pt"), model)
    assert meta["source"].endswith("epoch_64.pth")
    assert load_codec_params(model, {
        f"{p}_ckpt": os.path.join(vae_dir, f"{p}.pt")
        for p in ("upper", "hands", "face", "lowertrans")}) == [
        "upper", "hands", "face", "lowertrans"]
    fgd = evaluate.build_fgd_fn(os.path.join(root, "experiments", "fgd",
                                             "aesconv.pt"), device="cpu")
    assert fgd is not None
