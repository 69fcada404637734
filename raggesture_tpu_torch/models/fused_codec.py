"""The stacked 3-part codec decode.  Port of ``stack_codec_params`` and
``fused_decode`` of ``raggesture_tpu/models/fused_codec.py``.

Upper, hands and face share one decoder structure (D 512, 9 skip-connected
layers of 32 heads, ff 1024) and differ only in their feature counts (78,
180, 106).  Their decode parameters are stacked along a leading axis of 3,
the output projection zero-padded to 180 features (the padded columns are
sliced away), and the three decoders run as one: every linear is one
batched product over the stack, and every self-attention one call of
kernel K2 over (3·B, T, 512), the port's form of the JAX package's ``vmap``
over its kernel.  Lowertrans (64 heads) keeps its own pass.  A clip's
decode then launches K2 18 times instead of 36.

The stack is a copy of the parameters, built once per generator
(``StagedGenerator._refresh_prologue``); only the decode's parameters are
stacked (the stacked encode is not ported: ROADMAP §C).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as Fn

from .codec import GestureCodec, decoded_parts
from .layers import LN_EPS
from .vae import attend

STACK_PARTS = ("upper", "hands", "face")
PAD_NFEATS = 180     # the widest stacked part (hands)
_DECODE_PREFIXES = ("decoder.", "query_pos_decoder.", "final_layer.")


def stackable(cfg) -> bool:
    """Whether a ``CodecConfig``'s part VAEs are the shipped structure that
    the stacked decode implements (all_encoder, post-norm, GELU, learned
    positions)."""
    return (cfg.decoder_arch, cfg.normalize_before, cfg.activation,
            cfg.position_embedding) == ("all_encoder", False, "gelu",
                                        "learned")


def stack_codec_params(codec: GestureCodec) -> Dict[str, torch.Tensor]:
    """{name: (3, ...)}: the decode parameters of upper, hands and face
    (by their ``TransformerVAE`` names), the output projection padded with
    zero rows to ``PAD_NFEATS``."""
    if not stackable(codec.cfg):
        raise ValueError("the stacked decode takes the shipped part VAEs "
                         "(all_encoder, post-norm, GELU, learned positions); "
                         "decode part by part (fused_codec=False)")
    vaes = [getattr(codec, f"{p}_vae") for p in STACK_PARTS]
    stacked = {}
    for name, _ in vaes[0].named_parameters():
        if not name.startswith(_DECODE_PREFIXES):
            continue
        leaves = []
        for vae in vaes:
            t = vae.get_parameter(name).detach()
            if name.startswith("final_layer."):
                pad = PAD_NFEATS - t.shape[0]
                t = Fn.pad(t, (0, 0, 0, pad) if t.dim() == 2 else (0, pad))
            leaves.append(t)
        stacked[name] = torch.stack(leaves)
    return stacked


def _linear(x: torch.Tensor, p: Dict[str, torch.Tensor], name: str
            ) -> torch.Tensor:
    """x (3, N, Din) through the stacked Linear ``name`` -> (3, N, Dout)."""
    return torch.baddbmm(p[name + ".bias"][:, None], x,
                         p[name + ".weight"].transpose(1, 2))


def _layer_norm(x: torch.Tensor, p: Dict[str, torch.Tensor], name: str
                ) -> torch.Tensor:
    y = Fn.layer_norm(x, x.shape[-1:], eps=LN_EPS)
    return y * p[name + ".weight"][:, None] + p[name + ".bias"][:, None]


def _encoder_layer(x, pos, p, name: str, B: int, heads: int):
    """A post-norm encoder layer over the stack; x, pos (3, B·T, D)."""
    S, N, D = x.shape
    qk = x + pos
    qd = _linear(qk, p, f"{name}.self_attn.q_proj")
    kd = _linear(qk, p, f"{name}.self_attn.k_proj")
    vd = _linear(x, p, f"{name}.self_attn.v_proj")
    shape = (S * B, N // B, D)        # reshape, never a strided view
    att = attend(qd.reshape(shape), kd.reshape(shape), vd.reshape(shape),
                 heads).reshape(S, N, D)
    x = _layer_norm(x + _linear(att, p, f"{name}.self_attn.out_proj"), p,
                    f"{name}.norm1")
    ff = _linear(Fn.gelu(_linear(x, p, f"{name}.linear1")), p,
                 f"{name}.linear2")
    return _layer_norm(x + ff, p, f"{name}.norm2")


@torch.no_grad()
def fused_decode(codec: GestureCodec, stacked: Dict[str, torch.Tensor],
                 z: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``GestureCodec.decode`` with upper, hands and face decoded as one
    stack: (B, 43, D) -> the same keys and values (up to rounding).
    ``stacked`` is :func:`stack_codec_params` of ``codec``."""
    cfg = codec.cfg
    B, T, D = z.shape
    L = (T - 3) // 4
    n_frames = L * cfg.frame_chunk_size
    z3 = torch.stack([z[:, :L], z[:, L + 1:2 * L + 1],
                      z[:, 2 * L + 2:3 * L + 2]])
    xseq = torch.cat([z3, z3.new_zeros(3, B, n_frames, D)], dim=2)
    Tx = L + n_frames
    pos = xseq + stacked["query_pos_decoder.pe"][:, None, :Tx]
    x, pos = xseq.reshape(3, B * Tx, D), pos.reshape(3, B * Tx, D)
    dec = codec.upper_vae.decoder
    heads = cfg.vae_config("upper").num_heads * 8
    xs = []
    for i in range(dec.num_block):
        x = _encoder_layer(x, pos, stacked, f"decoder.input_{i}", B, heads)
        xs.append(x)
    x = _encoder_layer(x, pos, stacked, "decoder.middle", B, heads)
    for i in range(dec.num_block):
        x = _linear(torch.cat([x, xs.pop()], -1), stacked,
                    f"decoder.skip_linear_{i}")
        x = _encoder_layer(x, pos, stacked, f"decoder.output_{i}", B, heads)
    x = _layer_norm(x, stacked, "decoder.final_norm")
    x = x.reshape(3, B, Tx, D)[:, :, L:].reshape(3, B * n_frames, D)
    out3 = _linear(x, stacked, "final_layer").reshape(3, B, n_frames,
                                                      PAD_NFEATS)
    out = {p: out3[j, ..., :cfg.vae_config(p).nfeats]
           for j, p in enumerate(STACK_PARTS)}
    out["lowertrans"] = codec.lowertrans_vae.decode(z[:, 3 * L + 3:],
                                                    n_frames)
    return decoded_parts(out)
