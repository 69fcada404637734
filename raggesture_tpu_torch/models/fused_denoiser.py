"""Sampling apply-path of the denoiser: one DecoderLayer kernel per layer.

Port of the layer-kernel branch of
``raggesture_tpu/models/fused_denoiser.py::fused_denoise_ctx`` and of the
per-run precomputes around it.  The eager ``GestureDenoiser`` holds the
weights; this module re-lays them out once per generator (``pack_layers``,
``adaln_table``) and once per run (``precompute_cross_contexts``,
``stack_layer_contexts``, ``layer_kernel_mask_rows``), so that each of the
sampling loop's denoiser calls is an embedding, one
``ops.decoder_layer.fused_decoder_layer`` per layer and the output head.

The precomputes are plain tensor work (the JAX package left them to XLA,
outside any Pallas kernel):
  * in linear cross-attention the context softmax_time(k)ᵀ v depends on the
    conditions only, so each layer's three contexts are computed once per
    run, per head: (B, 3, H, Dh, Dh);
  * every step shares its timestep across the batch, so the adaLN
    (scale, shift) rows of all steps, layers and stylization slots are one
    product per generator: (S, L, 5, D) each.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as Fn

from ..ops.decoder_layer import fused_decoder_layer, pack_decoder_layer
from ..ops.linear_attention import (
    NEG_MASK,
    linear_attention_context,
    time_softmax_k,
)
from .denoiser import COND_KEYS, DenoiserConfig, GestureDenoiser

STYL_SLOTS = ("sa", "xf_text", "xf_audio", "xf_spk", "ffn")


def _stylization(layer, slot: str):
    block = (layer.sa_block if slot == "sa" else
             layer.ffn if slot == "ffn" else getattr(layer, f"ca_{slot}"))
    return block.proj_out


@torch.no_grad()
def adaln_table(den: GestureDenoiser, t_all: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The adaLN rows of every sampling step: ``t_all`` (S,) original-scale
    timesteps -> (scale, shift), each (S, num_layers, 5, D) contiguous, the
    5 slots in ``STYL_SLOTS`` order."""
    c = den.cfg
    emb = den.time_embedding(t_all)
    layers = [_stylization(den.block(i), s).emb_layer
              for i in range(c.num_layers) for s in STYL_SLOTS]
    W = torch.cat([e.weight for e in layers], dim=0)   # (n·2D, TE)
    b = torch.cat([e.bias for e in layers], dim=0)
    out = (Fn.silu(emb) @ W.t() + b).reshape(
        -1, c.num_layers, len(STYL_SLOTS), 2, c.latent_dim)
    return out[:, :, :, 0].contiguous(), out[:, :, :, 1].contiguous()


@torch.no_grad()
def cross_context(ca, xf: torch.Tensor, cond_mask, num_heads: int
                  ) -> torch.Tensor:
    """(B, N, D) conditions -> per-head linear-attention context
    (B, H, Dh, Dh) of one EfficientCrossAttention block."""
    xfn = ca.text_norm(xf)
    k = ca.key(xfn)
    if cond_mask is not None:
        k = k + (1.0 - cond_mask) * NEG_MASK
        v = ca.value(xfn * cond_mask)
    else:
        v = ca.value(xfn)
    return linear_attention_context(time_softmax_k(k), v, num_heads)


def precompute_cross_contexts(den: GestureDenoiser,
                              conds: Dict[str, torch.Tensor], cond_mask
                              ) -> Dict:
    c = den.cfg
    return {(i, key): cross_context(getattr(den.block(i), f"ca_{key}"),
                                    conds[key], cond_mask, c.ca_heads)
            for i in range(c.num_layers) for key in COND_KEYS}


def stack_layer_contexts(cfg: DenoiserConfig, ctx_cache: Dict,
                         dtype: torch.dtype) -> tuple:
    """Per-layer (B, 3, H, Dh, Dh) context stacks in the packs' dtype."""
    return tuple(torch.stack([ctx_cache[(i, key)] for key in COND_KEYS],
                             dim=1).to(dtype).contiguous()
                 for i in range(cfg.num_layers))


def padded_tokens(num_tokens: int) -> int:
    """Tokens per sequence in the layer kernel's rows (a multiple of 8)."""
    return -(-num_tokens // 8) * 8


def layer_kernel_mask_rows(motion_mask: torch.Tensor,
                           query_masks: Dict[str, torch.Tensor]):
    """(B·Tp, 1) validity and (B·Tp, 3) query-mask rows; padding rows are 0."""
    B, T = motion_mask.shape
    pad = padded_tokens(T) - T
    m = Fn.pad(motion_mask.float().reshape(B, T, 1), (0, 0, 0, pad))
    qm3 = torch.stack([query_masks[key].reshape(B, T).float()
                       for key in COND_KEYS], dim=-1)
    qm = Fn.pad(qm3, (0, 0, 0, pad))
    return m.reshape(-1, 1).contiguous(), qm.reshape(-1, 3).contiguous()


def pack_layers(den: GestureDenoiser, dtype: torch.dtype) -> tuple:
    return tuple(pack_decoder_layer(den.block(i), dtype)
                 for i in range(den.cfg.num_layers))


@torch.no_grad()
def fused_denoise_ctx(den: GestureDenoiser, latents: torch.Tensor,
                      scale_rows: torch.Tensor, shift_rows: torch.Tensor,
                      packed_layers: tuple, ctx3_list: tuple,
                      mask_rows: torch.Tensor, qmask_rows: torch.Tensor,
                      layer_fn: Callable = fused_decoder_layer
                      ) -> torch.Tensor:
    """One denoiser call at a shared timestep: latents (B, T, D) ->
    prediction (B, T, D).  ``scale_rows``/``shift_rows`` are this step's
    (num_layers, 5, D) adaLN rows; ``layer_fn`` is the layer kernel's
    wrapper (its plain version for a comparison)."""
    c = den.cfg
    B, T, D = latents.shape
    Tp = padded_tokens(T)
    h = den.embed_tokens(latents)
    h_rows = Fn.pad(h, (0, 0, 0, Tp - T)).reshape(B * Tp, D)
    for i in range(c.num_layers):
        h_rows = layer_fn(h_rows, mask_rows, qmask_rows, scale_rows[i],
                          shift_rows[i], ctx3_list[i], packed_layers[i],
                          c.num_heads, c.ca_heads, B)
    return den.out(h_rows.reshape(B, Tp, D)[:, :T])
