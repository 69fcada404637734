"""Softmax-feature-map linear attention, the denoiser's core op.

Port of ``raggesture_tpu/ops/linear_attention.py``: queries are softmaxed
over each head's feature dim, keys over time (after an additive -1e6 mask),
and the two contractions

    ctx = einsum('bnhd,bnhl->bhdl', K, V)   # sum over time
    out = einsum('bnhd,bhdl->bnhl', Q, ctx) # per-token readout

cost O(T · D²/H).  The JAX package's 128-lane head grouping
(``group_size`` / ``head_group_mask``) was a TPU layout device; per head is
the same math.
"""

from __future__ import annotations

import torch

NEG_MASK = -1_000_000.0  # the reference's additive mask constant


def feature_softmax_q(q: torch.Tensor) -> torch.Tensor:
    """Softmax over the per-head feature dim. q: (B, T, H, Dh)."""
    return torch.softmax(q, dim=-1)


def time_softmax_k(k: torch.Tensor) -> torch.Tensor:
    """Softmax over the time dim. k: (B, T, ...)."""
    return torch.softmax(k, dim=1)


def linear_attention_context(k: torch.Tensor, v: torch.Tensor,
                             num_heads: int) -> torch.Tensor:
    """Per-head context kᵀv: k, v flat (B, N, D) -> (B, H, Dh, Dh)."""
    B, N, D = k.shape
    Dh = D // num_heads
    return torch.einsum("bnhd,bnhl->bhdl", k.reshape(B, N, num_heads, Dh),
                        v.reshape(B, N, num_heads, Dh))


def apply_context(q: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
    """Per-head readout: q (B, T, H, Dh) with ctx (B, H, Dh, Dl) -> (B, T, H, Dl)."""
    return torch.einsum("bnhd,bhdl->bnhl", q, ctx)


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     num_heads: int) -> torch.Tensor:
    """q (B, T, H, Dh) feature-softmaxed; k, v flat (B, N, D), k
    time-softmaxed.  Returns (B, T, H, Dh)."""
    return apply_context(q, linear_attention_context(k, v, num_heads))
