"""Shared helpers of the PyTorch port's tests, and the port's two rules:
it imports nothing of JAX or of the JAX package, and its entry points run
on a CUDA card unless the caller asks for the CPU.

The other ``test_torch_*.py`` files import the helpers from here.  Inputs
are made with numpy from a seed and handed to both frameworks as numpy
arrays.
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_arch_config(jcfg):
    """The port's ArchitectureConfig with the values of a JAX one."""
    from raggesture_tpu_torch.models import architecture as A
    from raggesture_tpu_torch.models import codec as C
    from raggesture_tpu_torch.models import conditioning as K
    from raggesture_tpu_torch.models import denoiser as Dn

    return A.ArchitectureConfig(
        denoiser=same_fields(Dn.DenoiserConfig, jcfg.denoiser),
        codec=same_fields(C.CodecConfig, jcfg.codec),
        diffusion_train=same_fields(A.DiffusionSpec, jcfg.diffusion_train),
        diffusion_test=same_fields(A.DiffusionSpec, jcfg.diffusion_test),
        scale_func=(None if jcfg.scale_func is None
                    else same_fields(K.ScaleFuncConfig, jcfg.scale_func)),
        per_joint_scale=jcfg.per_joint_scale)


def same_fields(cls, obj):
    return cls(**{f.name: getattr(obj, f.name)
                  for f in dataclasses.fields(cls)})


def numpy_tree(tree):
    """A JAX parameter tree as nested dicts of numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, tree)


def randomize_zero_leaves(params, std=0.05, seed=0):
    """Give every all-zero leaf (the zero-initialised output heads and
    stylization/FFN second linears) normal(0, ``std``) values, in place, so
    that every path reaches the output."""
    rng = np.random.RandomState(seed)

    def go(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                go(v)
            elif np.asarray(v).size and np.allclose(np.asarray(v), 0):
                tree[k] = (std * rng.randn(*np.shape(v))).astype(np.float32)

    go(params)
    return params


def parity_query_masks_np(cfg, batch):
    """Query masks at the TRUE separators [L, 2L+1, 3L+2].  Production uses
    the reference's quirk indices [L, 2L, 3L], which add -1e6 to two valid
    tokens; the LayerNorm of (y - 1e6) cancels catastrophically in float32,
    so two implementations then differ at O(1) there.  Every comparison
    between the frameworks uses these masks instead."""
    m = np.ones((batch, cfg.num_tokens), np.float32)
    m[:, list(cfg.sep_indices)] = 0.0
    return {k: m for k in ("xf_text", "xf_audio", "xf_spk")}


def jax_denoiser_setup(B=2, layers=2, D=32, H=4, text_dim=24, seed=0):
    """A small JAX GestureDenoiser, its parameters with the zero-init leaves
    randomised, and numpy inputs for one call (as tests/test_fused_denoiser
    sets up its own)."""
    from raggesture_tpu.models.denoiser import (
        DenoiserConfig,
        GestureDenoiser,
        latent_motion_mask,
    )

    cfg = DenoiserConfig(latent_dim=D, time_embed_dim=4 * D,
                         num_layers=layers, num_heads=H, ff_size=2 * D,
                         dropout=0.0, text_latent_dim=text_dim,
                         audio_latent_dim=text_dim, num_speakers=5,
                         max_seq_len=30, frame_chunk_size=15)
    den = GestureDenoiser(cfg)
    rng = np.random.RandomState(seed)
    inputs = dict(
        word=rng.randn(B, 6, text_dim).astype(np.float32),
        audio=rng.randn(B, 8, text_dim).astype(np.float32),
        spk=np.asarray([1, 3, 0, 4][:B], np.int32),
        x=rng.randn(B, cfg.num_tokens, D).astype(np.float32),
        t=np.asarray([5, 900, 300, 40][:B], np.int32),
        mask=np.asarray(latent_motion_mask(
            cfg, jnp.ones((B, cfg.max_seq_len)))),
    )

    def run(mdl):
        cc = mdl.encode_conditions(inputs["word"], inputs["audio"],
                                   inputs["spk"])
        return mdl(inputs["x"], inputs["t"], inputs["mask"], cc,
                   parity_query_masks_np(cfg, B), jnp.ones((B, 1, 1)))

    import flax.linen as nn

    params = numpy_tree(nn.init(run, den)(jax.random.PRNGKey(seed)))
    params = {"params": randomize_zero_leaves(dict(params["params"]),
                                              seed=seed)}
    return cfg, den, params, inputs


def port_denoiser(jcfg, params):
    """The port's GestureDenoiser on the CPU, loaded from a JAX tree."""
    from raggesture_tpu_torch.models.denoiser import (
        DenoiserConfig,
        GestureDenoiser,
    )
    from raggesture_tpu_torch.utils.convert_jax import load_jax_params

    den = GestureDenoiser(same_fields(DenoiserConfig, jcfg)).eval()
    load_jax_params(den, params)
    return den


def jax_tree_from_port(model):
    """The JAX package's parameter tree ({"params": nested dicts of numpy
    arrays}) holding a port model's weights, flax's attention kernels at
    their (D, H, Dh) / (H, Dh, D) shapes: the inverse of
    ``load_jax_params``, so that a test can give both frameworks the
    port's random weights without initialising the JAX model."""
    from torch import nn

    tree = {}
    for name, p in model.named_parameters():
        *path, leaf = name.split(".")
        arr = p.detach().cpu().numpy()
        if leaf == "weight":
            mod = model.get_submodule(".".join(path))
            if isinstance(mod, nn.Linear):
                leaf, arr = "kernel", arr.T
            elif isinstance(mod, nn.LayerNorm):
                leaf = "scale"
            elif isinstance(mod, nn.Embedding):
                leaf = "embedding"
        if len(path) >= 2 and path[-2].startswith("attn_"):
            # a flax MultiHeadDotProductAttention's DenseGeneral shapes
            H = model.get_submodule(".".join(path[:-1])).num_heads
            if path[-1] == "out":
                arr = arr.reshape(H, -1, arr.shape[-1]) if leaf == "kernel" \
                    else arr
            else:
                arr = arr.reshape(arr.shape[:-1] + (H, -1))
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = np.ascontiguousarray(arr)
    return {"params": tree}


def port_model_and_jax_tree(jcfg, seed=0, zero_init_std=0.05):
    """A port model of the JAX config ``jcfg`` on the CPU with random
    weights from ``seed`` (every zero-initialised Linear given normal(0,
    ``zero_init_std``) values), and the same weights as a JAX tree."""
    from raggesture_tpu_torch.models.architecture import create_model

    model = create_model(port_arch_config(jcfg), device="cpu", seed=seed,
                         zero_init_std=zero_init_std)
    return model, jax_tree_from_port(model)


def t32(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# ---------------------------------------------------------------- the rules

_IMPORT_PROBE = r"""
import importlib, importlib.util, pkgutil, sys

def banned(name):
    return (name.split(".")[0] in ("jax", "jaxlib", "transformers",
                                   "safetensors", "ml_dtypes")
            or name == "raggesture_tpu" or name.startswith("raggesture_tpu."))

for name in [m for m in sys.modules if banned(m)]:
    del sys.modules[name]

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if banned(name):
            raise ImportError("the port must not import " + name)
        return None

sys.meta_path.insert(0, Refuse())
import raggesture_tpu_torch
names = [m.name for m in pkgutil.walk_packages(raggesture_tpu_torch.__path__,
                                               "raggesture_tpu_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
loaded = sorted(m for m in sys.modules if banned(m))
assert not loaded, loaded
print(len(names))
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """Every module of the port, and chip_smoke.py, imported in a fresh
    interpreter that refuses any import of jax or raggesture_tpu, and of
    what the card's machine lacks: transformers, safetensors, ml_dtypes."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _IMPORT_PROBE], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20   # every module was imported


def test_port_sources_name_no_jax():
    """The sources themselves: no import of jax or of the JAX package."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "raggesture_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path) as fh:
            for line in fh:
                words = line.split()
                if words[:1] in (["import"], ["from"]) and len(words) > 1:
                    top = words[1].split(".")[0]
                    assert top not in ("jax", "jaxlib", "raggesture_tpu",
                                       "transformers", "safetensors",
                                       "ml_dtypes"), (
                        f"{path}: {line.strip()}")


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch):
    from raggesture_tpu_torch.device import resolve_device
    from raggesture_tpu_torch.models.architecture import create_model
    from raggesture_tpu.datasets.fixtures import tiny_arch_config

    cfg = port_arch_config(tiny_arch_config())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model(cfg)
    # the serving tool and its model builder: the card unless --device
    from raggesture_tpu_torch.builders import build_architecture
    from raggesture_tpu_torch.config import Config
    from raggesture_tpu_torch.tools import visualize

    tiny = Config.fromfile(os.path.join(
        REPO, "configs/raggesture_beatx/tiny_smoke.py"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_architecture(tiny.model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        visualize.main(["config.py", "params.pt", "--out-dir", "unused"])
    assert build_architecture(tiny.model, device="cpu").cfg.denoiser.\
        latent_dim == 32
    model = create_model(cfg, device="cpu")
    assert next(model.parameters()).device.type == "cpu"


def test_kernel_wrappers_take_the_plain_version_only_on_the_cpu():
    """A tensor that is not on the CPU never reaches the plain version: the
    wrapper launches its kernel or raises (here: a meta tensor, refused)."""
    from raggesture_tpu_torch.ops.mha import (
        fused_softmax_mha,
        softmax_mha_reference,
    )

    rng = np.random.RandomState(0)
    q, k, v = (t32(rng.randn(1, 8, 16)) for _ in range(3))
    before = fused_softmax_mha.launches
    torch.testing.assert_close(fused_softmax_mha(q, k, v, 2, 0.5),
                               softmax_mha_reference(q, k, v, 2, 0.5),
                               rtol=0, atol=0)
    assert fused_softmax_mha.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        fused_softmax_mha(q.to("meta"), k.to("meta"), v.to("meta"), 2, 0.5)
    assert fused_softmax_mha.launches == before

    # the denoiser layer's block kernels K4, K5, K6, K7, K8
    from raggesture_tpu_torch.models.denoiser import (
        DenoiserConfig,
        GestureDenoiser,
    )
    from raggesture_tpu_torch.models.fused_denoiser import (
        pack_split_layers,
        pack_unfused_layers,
    )
    from raggesture_tpu_torch.ops import cross_attention as CA
    from raggesture_tpu_torch.ops import ffn as FF
    from raggesture_tpu_torch.ops import self_attention as SA

    B, T, D, H = 2, 11, 32, 2
    den = GestureDenoiser(DenoiserConfig(
        latent_dim=D, time_embed_dim=64, num_heads=H, ff_size=64,
        num_layers=1, text_latent_dim=8, audio_latent_dim=8))
    w = pack_split_layers(den)[0]
    x = t32(rng.randn(B, T, D))
    m1, m3 = torch.ones(B, T, 1), torch.ones(B, T, 3)
    s1, s3 = t32(rng.randn(B, D)), t32(rng.randn(B, 3, D))
    ctx3 = t32(rng.randn(B, 3, H, D // H, D // H))
    xf, cm = t32(rng.randn(B, 5, D)), t32([1.0, 0.0]).reshape(B, 1, 1)
    calls = [
        (CA.fused_cross_attention, CA.fused_cross_attention_reference,
         (x, xf, m1, cm, s1, s1, pack_unfused_layers(den)[0].cas[1], H)),
        (SA.fused_self_attention, SA.fused_self_attention_reference,
         (x, m1, s1, s1, w.sa, H)),
        (CA.fused_cross_attention_cached,
         CA.fused_cross_attention_cached_reference,
         (x, ctx3[:, 0], m1, s1, s1, w.cross_block.cas[0], H)),
        (CA.fused_cross_block_cached, CA.fused_cross_block_cached_reference,
         (x, ctx3, m3, s3, s3, w.cross_block, H)),
        (FF.fused_ffn, FF.fused_ffn_reference, (x, s1, s1, w.ffn)),
    ]
    for wrapper, plain, args in calls:
        before = wrapper.launches
        torch.testing.assert_close(wrapper(*args), plain(*args), rtol=0,
                                   atol=0)
        meta = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                     for a in args)
        with pytest.raises(ValueError, match="CUDA"):
            wrapper(*meta)
        assert wrapper.launches == before, wrapper.__name__


def test_port_config_defaults_equal_the_jax_package():
    """The port keeps its own copies of the config dataclasses; their
    defaults are the JAX package's."""
    from raggesture_tpu.models import architecture as JA
    from raggesture_tpu.models import vae as JV
    from raggesture_tpu_torch.models import architecture as A
    from raggesture_tpu_torch.models import vae as V

    assert port_arch_config(JA.ArchitectureConfig()) == A.ArchitectureConfig()
    for f in dataclasses.fields(V.VAEConfig):
        if f.name != "nfeats":
            assert f.default == JV.VAEConfig.__dataclass_fields__[
                f.name].default, f.name
