"""The model's parameters as the benchmark makes them: every name and shape
of a RAG-Gesture configuration, and random weights from a seed.

The names follow the model's state dict (denoiser blocks, the four part
VAEs), written out here from the configuration's widths alone, so that the
benchmark checks the program's parameter tree against this list (a strict
load) rather than reading it.  The weights are one normal draw on the
device from the seed, cut into the leaves and scaled by a rule on each
leaf's name; the same seed gives the same weights on the same device.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

COND_KEYS = ("xf_text", "xf_audio", "xf_spk")
PARTS = ("upper", "hands", "face", "lowertrans")
# per-frame features of each part VAE: 6d joints (+ jaw and expressions,
# + translation and foot contacts)
PART_FEATS = {"upper": 13 * 6, "hands": 30 * 6, "face": 6 + 100,
              "lowertrans": 9 * 6 + 3 + 4}
# the Linears the model starts at zero: given small random weights here so
# that every path reaches the output
SMALL_LINEARS = ("proj_out.out_proj.", "ffn.linear2.", "denoiser.out.")
SMALL_STD = 0.02


def _linear(out: list, name: str, d_out: int, d_in: int) -> None:
    out.append((f"{name}.weight", (d_out, d_in)))
    out.append((f"{name}.bias", (d_out,)))


def _norm(out: list, name: str, d: int) -> None:
    out.append((f"{name}.weight", (d,)))
    out.append((f"{name}.bias", (d,)))


def _stylization(out: list, name: str, D: int, TE: int) -> None:
    _linear(out, f"{name}.emb_layer", 2 * D, TE)
    _norm(out, f"{name}.norm", D)
    _linear(out, f"{name}.out_proj", D, D)


def denoiser_shapes(c: dict) -> List[Tuple[str, tuple]]:
    D, TE, F = c["latent_dim"], c["time_embed_dim"], c["ff_size"]
    out: list = []
    p = "denoiser"
    _linear(out, f"{p}.joint_embed", D, D)
    _linear(out, f"{p}.time_embed_1", TE, D)
    _linear(out, f"{p}.time_embed_2", TE, TE)
    _linear(out, f"{p}.text_pre_proj", D, c["text_latent_dim"])
    _linear(out, f"{p}.audio_pre_proj", D, c["audio_latent_dim"])
    out.append((f"{p}.speaker_embedding.weight", (c["num_speakers"], D)))
    out.append((f"{p}.global_positional_embedding.pe", (num_tokens(c), D)))
    for i in range(c["num_layers"]):
        b = f"{p}.block_{i}"
        _norm(out, f"{b}.sa_block.norm", D)
        for n in ("query", "key", "value"):
            _linear(out, f"{b}.sa_block.{n}", D, D)
        _stylization(out, f"{b}.sa_block.proj_out", D, TE)
        for key in COND_KEYS:
            ca = f"{b}.ca_{key}"
            _norm(out, f"{ca}.norm", D)
            _norm(out, f"{ca}.text_norm", D)
            for n in ("query", "key", "value"):
                _linear(out, f"{ca}.{n}", D, D)
            _stylization(out, f"{ca}.proj_out", D, TE)
        _linear(out, f"{b}.ca_mix", D, 3 * D)
        _linear(out, f"{b}.ffn.linear1", F, D)
        _linear(out, f"{b}.ffn.linear2", D, F)
        _stylization(out, f"{b}.ffn.proj_out", D, TE)
    _linear(out, f"{p}.out", D, D)
    return out


def _skip_stack(out: list, name: str, layers: int, D: int, F: int) -> None:
    n = layers + (1 if layers % 2 == 0 else 0)
    blocks = (n - 1) // 2

    def layer(ln: str) -> None:
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(out, f"{ln}.self_attn.{proj}", D, D)
        _linear(out, f"{ln}.linear1", F, D)
        _linear(out, f"{ln}.linear2", D, F)
        _norm(out, f"{ln}.norm1", D)
        _norm(out, f"{ln}.norm2", D)

    for i in range(blocks):
        layer(f"{name}.input_{i}")
    layer(f"{name}.middle")
    for i in range(blocks):
        _linear(out, f"{name}.skip_linear_{i}", D, 2 * D)
        layer(f"{name}.output_{i}")
    _norm(out, f"{name}.final_norm", D)


def codec_shapes(c: dict) -> List[Tuple[str, tuple]]:
    D, F = c["latent_dim"], c["ff_size"]
    out: list = []
    for part in PARTS:
        v = f"codec.{part}_vae"
        nf = PART_FEATS[part]
        out.append((f"{v}.global_motion_token", (2, D)))
        _linear(out, f"{v}.skel_embedding", D, nf)
        _linear(out, f"{v}.final_layer", nf, D)
        out.append((f"{v}.query_pos_encoder.pe", (c["pe_max_len"], D)))
        out.append((f"{v}.query_pos_decoder.pe", (c["pe_max_len"], D)))
        _skip_stack(out, f"{v}.encoder", c["num_layers"], D, F)
        _skip_stack(out, f"{v}.decoder", c["num_layers"], D, F)
    return out


def num_tokens(c: dict) -> int:
    L = c["max_seq_len"] // c["frame_chunk_size"]
    return 4 * L + 3


def param_shapes(config: dict) -> List[Tuple[str, tuple]]:
    """Every parameter of the configuration, in the model's order."""
    return codec_shapes(config["codec"]) + denoiser_shapes(config["denoiser"])


def _scale_shift(name: str, shape: tuple) -> Tuple[float, float]:
    """(std, mean) of a leaf's normal draw, by its name."""
    if name.endswith(".pe"):
        return SMALL_STD, 0.0
    if name.endswith("global_motion_token") or "speaker_embedding" in name:
        return 1.0, 0.0
    if any(s in name for s in SMALL_LINEARS):
        return SMALL_STD, 0.0
    if name.endswith(".bias"):
        return SMALL_STD, 0.0
    if len(shape) == 1:                     # a LayerNorm's scale
        return SMALL_STD, 1.0
    return 1.0 / math.sqrt(shape[1]), 0.0   # a Linear: 1/sqrt(fan_in)


@torch.no_grad()
def make_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's weights from ``seed``: one float32 normal draw
    on ``device``, each leaf a view of it scaled and shifted in place."""
    shapes = param_shapes(config)
    total = sum(math.prod(s) for _, s in shapes)
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=g, device=device)
    out, off = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        leaf = flat[off:off + n].view(shape)
        std, mean = _scale_shift(name, shape)
        leaf.mul_(std).add_(mean)
        out[name] = leaf
        off += n
    return out
