"""The reference's torch checkpoints onto the port's modules.

Port of ``raggesture_tpu/utils/convert_torch.py``: the released part VAEs
(``convert_vae``), the denoiser (``convert_denoiser``), the whole release
(``convert_release``: the mmcv ``epoch_64.pth`` with its ``model.`` prefix
and its embedded VAEs, or standalone per-part VAE files) and the FGD
embedder (``convert_fgd``).  The reference is PyTorch too, so a converted
state keeps the reference's layouts: a Linear's weight stays (out, in), a
LayerNorm's weight stays ``weight``.  What changes is the names, to the
port's modules (which carry the JAX tree's names), and three layouts:
``nn.MultiheadAttention``'s packed ``in_proj_weight`` (3D, D) is split into
``q_proj``/``k_proj``/``v_proj``, a learned position table (L, 1, D)
becomes (L, D), and the FGD embedder's SkeletonConv masks are baked into
its weights.  ``convert_vae``, ``convert_denoiser`` and ``convert_release``
return a port state dict ({name: np.ndarray}, views of the input where no
layout changes) that ``load_converted`` (through ``assert_tree_matches``)
puts into a model strictly; the values are bit for bit those that the JAX
package's converters give after ``utils/convert_jax.py::load_jax_params``.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional

import numpy as np
import torch
from torch import nn


def strip_prefix(state: Dict[str, np.ndarray], prefix: str
                 ) -> Dict[str, np.ndarray]:
    """Remove a key prefix (DDP "module." / mmcv "model.") where a key has
    it; other keys are kept verbatim."""
    return {(k[len(prefix):] if k.startswith(prefix) else k): v
            for k, v in state.items()}


def load_torch_state(path: str) -> Dict[str, np.ndarray]:
    """A torch checkpoint file as {name: np.ndarray}, out of the
    reference's containers ({"model_state": ...} for the VAEs and the FGD
    model, {"state_dict": ...} for mmcv) or a raw state dict; tensors only,
    DDP's "module." prefix stripped.  Read with ``weights_only=True``:
    tensors and plain containers, no arbitrary pickled objects."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model_state", "state_dict", "model"):
        if isinstance(blob, dict) and isinstance(blob.get(key), dict):
            blob = blob[key]
            break
    state = {k: v.detach().cpu().numpy() for k, v in blob.items()
             if isinstance(v, torch.Tensor)}
    return strip_prefix(state, "module.")


# buffers of the reference's modules that the port recomputes or does not
# use: the denoiser's sinusoidal ``sequence_embedding.pe`` (detr_utils.py:
# 27-48) and the all_encoder VAE's unused ``mem_pos_decoder.pe``
# (gesture_vae.py:36-44), as tests/test_convert_golden.py documents them
BUFFERS = ("sequence_embedding.pe", "mem_pos_decoder.pe")


class _Tracked(dict):
    """A state whose reads are recorded, so a converter can refuse a key
    that nothing read."""

    def __init__(self, state: Mapping):
        super().__init__(state)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)

    def unread(self, allowed: Iterable[str] = BUFFERS) -> list:
        return sorted(k for k in self if k not in self.read
                      and k not in set(allowed))


def _strict(state: Mapping, convert, what: str):
    tracked = _Tracked(state)
    out = convert(tracked)
    unread = tracked.unread()
    if unread:
        raise KeyError(f"{what}: {len(unread)} checkpoint keys map to "
                       f"nothing, e.g. {unread[:5]}")
    return out


# -- leaf converters ---------------------------------------------------------
# each returns {port name relative to ``key``'s module: array}

def _linear(state, key, name):
    return {f"{name}.weight": state[f"{key}.weight"],
            f"{name}.bias": state[f"{key}.bias"]}


_layernorm = _linear    # LayerNorm weight / bias keep their names


def _mha(state, key, name):
    """``nn.MultiheadAttention`` -> ``models/vae.py::TorchMHA``: the packed
    (3D, D) in-projection split into q / k / v in that order."""
    w = state[f"{key}.in_proj_weight"]
    b = state[f"{key}.in_proj_bias"]
    D = w.shape[1]
    out = {}
    for i, proj in enumerate(("q_proj", "k_proj", "v_proj")):
        out[f"{name}.{proj}.weight"] = w[i * D:(i + 1) * D]
        out[f"{name}.{proj}.bias"] = b[i * D:(i + 1) * D]
    out.update(_linear(state, f"{key}.out_proj", f"{name}.out_proj"))
    return out


def _transformer_layer(state, key, name, decoder: bool):
    """``nn.TransformerEncoderLayer`` -> ``vae.EncoderLayer``, or
    ``nn.TransformerDecoderLayer`` -> ``vae.DecoderLayerTorch``."""
    out = _mha(state, f"{key}.self_attn", f"{name}.self_attn")
    if decoder:
        out.update(_mha(state, f"{key}.multihead_attn",
                        f"{name}.multihead_attn"))
    for sub in ("linear1", "linear2", "norm1", "norm2") + (
            ("norm3",) if decoder else ()):
        out.update(_linear(state, f"{key}.{sub}", f"{name}.{sub}"))
    return out


def _skip_stack(state, key, name, num_layers: int, decoder: bool = False):
    """SkipTransformerEncoder/Decoder (reference detr_utils.py:101-210) ->
    ``vae.SkipTransformerEncoder``/``Decoder`` (input_i, middle, output_i,
    skip_linear_i, final_norm)."""
    n = num_layers + (1 if num_layers % 2 == 0 else 0)
    out = {}
    for i in range((n - 1) // 2):
        out.update(_transformer_layer(state, f"{key}.input_blocks.{i}",
                                      f"{name}.input_{i}", decoder))
        out.update(_transformer_layer(state, f"{key}.output_blocks.{i}",
                                      f"{name}.output_{i}", decoder))
        out.update(_linear(state, f"{key}.linear_blocks.{i}",
                           f"{name}.skip_linear_{i}"))
    out.update(_transformer_layer(state, f"{key}.middle_block",
                                  f"{name}.middle", decoder))
    out.update(_layernorm(state, f"{key}.norm", f"{name}.final_norm"))
    return out


def _learned_pe(state, key, name):
    return {f"{name}.pe": state[f"{key}.pe"][:, 0, :]}


def _prefixed(prefix: str, state: Mapping) -> Dict:
    return {f"{prefix}.{k}": v for k, v in state.items()}


# -- module converters -------------------------------------------------------

def convert_vae(state: Mapping[str, np.ndarray], num_layers: int = 8,
                position_embedding: str = "learned",
                decoder_arch: str = "all_encoder") -> Dict[str, np.ndarray]:
    """One body-part TransformerVAE state dict (reference gesture_vae.py:
    25-96) -> the port's ``TransformerVAE`` state dict.  The reference
    builds ``mem_pos_decoder`` for every VAE; the shipped ``all_encoder``
    decoder does not use it, so it is read only for ``encoder_decoder``
    (whose decoder stacks ``(num_layers - 1) * 4 + 1``
    TransformerDecoderLayers).  Raises KeyError on a key of ``state`` that
    nothing reads, ``BUFFERS`` excepted."""
    return _strict(state, lambda st: _vae(st, num_layers, position_embedding,
                                          decoder_arch), "vae")


def _vae(state, num_layers, position_embedding, decoder_arch):
    out = {"global_motion_token": state["global_motion_token"]}
    out.update(_linear(state, "skel_embedding", "skel_embedding"))
    out.update(_linear(state, "final_layer", "final_layer"))
    out.update(_skip_stack(state, "encoder", "encoder", num_layers))
    if decoder_arch == "all_encoder":
        out.update(_skip_stack(state, "decoder", "decoder", num_layers))
    else:
        out.update(_skip_stack(state, "decoder", "decoder",
                               (num_layers - 1) * 4 + 1, decoder=True))
    if position_embedding == "learned":
        pes = ["query_pos_encoder", "query_pos_decoder"]
        if decoder_arch != "all_encoder":
            pes.append("mem_pos_decoder")
        for pe in pes:
            out.update(_learned_pe(state, pe, pe))
    return out


def _stylization(state, key, name):
    """StylizationBlock (stylization_block.py:14-40) ->
    ``layers.StylizationBlock``."""
    out = _linear(state, f"{key}.emb_layers.1", f"{name}.emb_layer")
    out.update(_layernorm(state, f"{key}.norm", f"{name}.norm"))
    out.update(_linear(state, f"{key}.out_layers.2", f"{name}.out_proj"))
    return out


def _efficient_attention(state, key, name, cross: bool):
    out = {}
    for sub in ("norm", "query", "key", "value") + (
            ("text_norm",) if cross else ()):
        out.update(_linear(state, f"{key}.{sub}", f"{name}.{sub}"))
    out.update(_stylization(state, f"{key}.proj_out", f"{name}.proj_out"))
    return out


def convert_denoiser(state: Mapping[str, np.ndarray], num_layers: int = 8
                     ) -> Dict[str, np.ndarray]:
    """ReGestureTransformer state dict (reference raggesture.py:887-1114 over
    DiffusionTransformer, diffusion_transformer.py:334-431), its ``model.``
    prefix stripped, -> the port's ``GestureDenoiser`` state dict.  The
    768->512 pre-projections are Linear in the shipped config; with matching
    widths the reference makes them Identity and they are absent from the
    state, and then from the result too (the port always has them, so
    ``assert_tree_matches`` names them missing).  ``sequence_embedding.pe``
    is the reference's sinusoidal buffer, which the port recomputes.  Raises
    KeyError on any other key that nothing reads (the embedded VAEs'
    ``gesture_rep_encoder.*`` belong to :func:`convert_release`)."""
    return _strict(
        {k: v for k, v in state.items()
         if not k.startswith("gesture_rep_encoder.")},
        lambda st: _denoiser(st, num_layers), "denoiser")


def _denoiser(state, num_layers):
    out = {"speaker_embedding.weight": state["speaker_embedding.weight"]}
    out.update(_linear(state, "joint_embed", "joint_embed"))
    out.update(_linear(state, "time_embed.0", "time_embed_1"))
    out.update(_linear(state, "time_embed.2", "time_embed_2"))
    out.update(_learned_pe(state, "global_positional_embedding",
                           "global_positional_embedding"))
    out.update(_linear(state, "out", "out"))
    for proj in ("text_pre_proj", "audio_pre_proj"):
        if f"{proj}.weight" in state:
            out.update(_linear(state, proj, proj))
    for i in range(num_layers):
        key, name = f"temporal_decoder_blocks.{i}", f"block_{i}"
        out.update(_efficient_attention(state, f"{key}.sa_block",
                                        f"{name}.sa_block", False))
        for stream in ("text", "audio", "spk"):
            out.update(_efficient_attention(
                state, f"{key}.ca_blocks.xf_{stream}",
                f"{name}.ca_xf_{stream}", True))
        out.update(_linear(state, f"{key}.ca_mix", f"{name}.ca_mix"))
        for sub in ("linear1", "linear2"):
            out.update(_linear(state, f"{key}.ffn.{sub}",
                               f"{name}.ffn.{sub}"))
        out.update(_stylization(state, f"{key}.ffn.proj_out",
                                f"{name}.ffn.proj_out"))
    return out


PART_ATTR = {"upper": "upper_vae", "hands": "hands_vae", "face": "face_vae",
             "lowertrans": "lowertrans_vae"}


def convert_release(denoiser_state: Mapping[str, np.ndarray],
                    vae_states: Optional[Mapping[str, Mapping]] = None,
                    num_layers: int = 8, vae_num_layers: int = 8
                    ) -> Dict[str, np.ndarray]:
    """The whole ``MotionDiffusionModel``'s state dict (``codec.*`` and
    ``denoiser.*``) from the mmcv checkpoint's state (keys prefixed
    ``model.``, stripped here; the release embeds the four VAEs as
    ``gesture_rep_encoder.{part}_vae.*``) and optional standalone per-part
    VAE states ``{"upper": state, ...}``, which win over the embedded
    ones.  Every converter is strict (``BUFFERS`` excepted); the embedded
    VAE of a part given in ``vae_states`` is left unread, as in the JAX
    package."""
    state = strip_prefix(dict(denoiser_state), "model.")
    stray = sorted(k for k in state if k.startswith("gesture_rep_encoder.")
                   and k.split(".")[1] not in PART_ATTR.values())
    if stray:
        raise KeyError(f"release: {len(stray)} checkpoint keys map to "
                       f"nothing, e.g. {stray[:5]}")
    out = {}
    for part in PART_ATTR:
        if vae_states and part in vae_states:
            sub = vae_states[part]
        else:
            prefix = f"gesture_rep_encoder.{PART_ATTR[part]}."
            sub = {k[len(prefix):]: v for k, v in state.items()
                   if k.startswith(prefix)}
            if not sub:
                raise KeyError(
                    f"no weights for {part}: neither vae_states[{part!r}] "
                    f"nor embedded gesture_rep_encoder.{PART_ATTR[part]}.*")
        out.update(_prefixed(f"codec.{part}_vae",
                             convert_vae(sub, vae_num_layers)))
    out.update(_prefixed("denoiser", convert_denoiser(state, num_layers)))
    return out


def assert_tree_matches(converted: Mapping[str, np.ndarray],
                        model: nn.Module, path: str = "") -> None:
    """Strict check of a converted state against ``model.state_dict()``:
    raises ValueError naming every missing, unexpected or mis-shaped key."""
    own = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    conv = {k: tuple(np.shape(v)) for k, v in converted.items()}
    missing = sorted(set(own) - set(conv))
    extra = sorted(set(conv) - set(own))
    mismatched = sorted(k for k in set(own) & set(conv) if own[k] != conv[k])
    if missing or extra or mismatched:
        raise ValueError(
            f"state mismatch at {path or 'root'}:\n"
            f"  missing from conversion: {missing[:10]}\n"
            f"  unexpected in conversion: {extra[:10]}\n"
            f"  shape mismatches: "
            f"{[(k, conv[k], own[k]) for k in mismatched[:10]]}")


@torch.no_grad()
def load_converted(model: nn.Module, converted: Mapping[str, np.ndarray]
                   ) -> None:
    """Copy a converted state into ``model`` after
    :func:`assert_tree_matches`: nothing is copied unless every key fits."""
    assert_tree_matches(converted, model)
    own = model.state_dict()
    for k, v in converted.items():
        own[k].copy_(torch.as_tensor(np.asarray(v, np.float32)))


@torch.no_grad()
def convert_fgd(state: Mapping[str, np.ndarray], model: nn.Module) -> None:
    """Fill ``model`` (an ``FGDEmbedder``) from a VAESKConv state dict
    (reference mogen/models/eval_models/model.py:244-252).

    Encoder stage i: ``encoder.layers.{i}.0.residual.0`` SkeletonConv (its
    ``.mask`` baked into the weight), ``.residual.1`` GroupNorm,
    ``.0.shortcut`` SkeletonConv, and ``.0.common.0.weight`` the stage's
    mean-pool matrix where it pools.  Decoder (VQDecoderV3): two ResBlocks
    (``decoder.main.{idx}.model.{0,2}``), then the upsample stages' convs
    and the final conv, all (out, in, k) as the port's.  The released file
    carries ``fc_mu`` / ``fc_logvar`` (VAEConv always makes them); a
    non-variational embedder, as evaluation runs it, does not read them.

    Raises on a key nothing reads, a parameter nothing fills, a shape
    mismatch, or a mask or pool matrix other than the model's topology."""
    state = {k: np.asarray(v, np.float32) for k, v in state.items()}
    used = set()

    def take(key):
        used.add(key)
        return state[key]

    def same_constant(key, want: torch.Tensor):
        if not np.array_equal(take(key), want.cpu().numpy()):
            raise ValueError(f"{key} is not the model's skeleton topology")

    out: Dict[str, np.ndarray] = {}
    i = 0
    while f"encoder.layers.{i}.0.residual.0.weight" in state:
        base = f"encoder.layers.{i}.0"
        layer = getattr(model.encoder, f"layer_{i}", None)
        if layer is None:
            raise KeyError(f"{base}: the model has {i} encoder stages")
        for src, dst in (("residual.0", "conv"), ("shortcut", "shortcut")):
            w = take(f"{base}.{src}.weight")
            if f"{base}.{src}.mask" in state:
                same_constant(f"{base}.{src}.mask", getattr(layer, dst).mask)
                w = w * state[f"{base}.{src}.mask"]
            out[f"encoder.layer_{i}.{dst}.weight"] = w
            out[f"encoder.layer_{i}.{dst}.bias"] = take(f"{base}.{src}.bias")
        out[f"encoder.layer_{i}.norm.weight"] = take(f"{base}.residual.1.weight")
        out[f"encoder.layer_{i}.norm.bias"] = take(f"{base}.residual.1.bias")
        pool = f"{base}.common.0.weight"
        if (pool in state) != layer.do_pool:
            raise ValueError(f"{base}: the checkpoint and the model disagree "
                             f"on whether stage {i} pools")
        if layer.do_pool:
            same_constant(pool, layer.pool_w)
        i += 1
    if i == 0:
        raise KeyError("no encoder.layers.*.0.residual.0.weight in the state "
                       "dict: is this a VAESKConv checkpoint?")

    # decoder.main.{idx}: ResBlocks carry .model.{0,2}, convs .weight
    res_idx = sorted({int(k.split(".")[2]) for k in state
                      if k.startswith("decoder.main.") and ".model." in k})
    conv_idx = sorted({int(k.split(".")[2]) for k in state
                       if k.startswith("decoder.main.")
                       and ".model." not in k and k.endswith(".weight")})
    for n, idx in enumerate(res_idx):
        for m, sub in ((1, 0), (2, 2)):
            for suffix, leaf in (("w", "weight"), ("b", "bias")):
                out[f"decoder.res{n}_c{m}_{suffix}"] = take(
                    f"decoder.main.{idx}.model.{sub}.{leaf}")
    # the upsample stages' convs are all but the last plain conv
    names = [f"up{n}" for n in range(len(conv_idx) - 1)] + ["final"]
    for name, idx in zip(names, conv_idx):
        out[f"decoder.{name}_w"] = take(f"decoder.main.{idx}.weight")
        out[f"decoder.{name}_b"] = take(f"decoder.main.{idx}.bias")

    for fc in ("fc_mu", "fc_logvar"):
        for leaf in ("weight", "bias"):
            key = f"{fc}.{leaf}"
            if key in state:
                if model.cfg.variational:
                    out[key] = state[key]
                used.add(key)

    unused = sorted(set(state) - used)
    if unused:
        raise KeyError(f"{len(unused)} checkpoint keys map to nothing, e.g. "
                       f"{unused[:5]}")
    params = dict(model.named_parameters())
    extra = sorted(set(out) - set(params))
    missing = sorted(set(params) - set(out))
    if extra or missing:
        raise KeyError(f"checkpoint and model differ: no parameter for "
                       f"{extra[:5]}, nothing fills {missing[:5]}")
    for name, arr in out.items():
        if tuple(arr.shape) != tuple(params[name].shape):
            raise ValueError(f"{name}: checkpoint {arr.shape}, model "
                             f"{tuple(params[name].shape)}")
    for name, arr in out.items():
        params[name].copy_(torch.from_numpy(arr))
