"""Shared building blocks: timestep and position embeddings, adaLN
stylization, FFN, and dropout from explicit draws.  Port of
``raggesture_tpu/models/layers.py``.

Parameters keep the JAX tree's names (a Dense ``kernel`` is a Linear
``weight``, transposed; a LayerNorm ``scale`` is its ``weight``) so that
``utils/convert_jax.py`` maps them mechanically.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as Fn
from torch import nn

LN_EPS = 1e-5  # torch's epsilon, which the JAX package also uses


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


def zero_init(linear: nn.Linear) -> nn.Linear:
    """Mark a Linear as zero-initialised, as the JAX package's zeros_init
    leaves are (see ``architecture.init_weights``)."""
    linear.zero_init = True
    return linear


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding (N,) -> (N, dim), cos block first."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def sine_position_table(max_len: int, d_model: int,
                        device=None) -> torch.Tensor:
    """DETR-style interleaved sine table: pe[:, 0::2] = sin, pe[:, 1::2] = cos."""
    position = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    div_term = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32,
                                      device=device)
                         * (-math.log(10000.0) / d_model))
    pe = torch.zeros(max_len, d_model, device=device)
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term)
    return pe


class DropoutDraws:
    """Dropout whose masks come from a ``torch.Generator``, in the order of
    the calls: ``drop(x, rate)`` keeps each element with probability
    ``1 - rate`` and scales what it keeps by ``1 / (1 - rate)`` (flax's
    ``nn.Dropout``); rate 0 returns ``x``.  ``rows = (start, global_batch)``
    draws each mask for a global batch of ``global_batch`` rows and takes
    rows ``start:start + B``: a data-parallel rank then draws the masks of
    its rows of a one-process run on the whole batch."""

    def __init__(self, generator: torch.Generator, rows=None):
        self.generator = generator
        self.rows = rows

    def __call__(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if rate <= 0.0:
            return x
        shape = tuple(x.shape)
        if self.rows is not None:
            shape = (self.rows[1],) + shape[1:]
        keep = torch.rand(shape, generator=self.generator,
                          device=x.device) >= rate
        if self.rows is not None:
            keep = keep[self.rows[0]:self.rows[0] + x.shape[0]]
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))

    def shared(self, x: torch.Tensor, rate: float, shape) -> torch.Tensor:
        """Dropout with ONE keep mask of ``shape`` broadcast over ``x``
        (flax's ``broadcast_dropout``: attention weights (B, H, N, N) take a
        (1, 1, N, N) mask, the same for every row and head, and so for
        every data-parallel rank's rows); rate 0 returns ``x``."""
        if rate <= 0.0:
            return x
        keep = torch.rand(tuple(shape), generator=self.generator,
                          device=x.device) >= rate
        return x * (keep.to(x.dtype) / (1.0 - rate))


def dropout(drop, x: torch.Tensor, rate: float) -> torch.Tensor:
    """``drop(x, rate)``, or ``x`` when ``drop`` is None (deterministic)."""
    return x if drop is None else drop(x, rate)


class LearnedPositionEmbedding(nn.Module):
    """Learned 1-D position table ``pe`` (max_len, d_model); x + pe[:T]."""

    def __init__(self, max_len: int, d_model: int):
        super().__init__()
        self.pe = nn.Parameter(torch.empty(max_len, d_model))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.pe[None, :x.shape[1]]


class StylizationBlock(nn.Module):
    """adaLN residual projector: SiLU(emb) -> scale/shift on LayerNorm(h),
    then SiLU -> dropout -> zero-init Linear."""

    def __init__(self, latent_dim: int, time_embed_dim: int,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.emb_layer = nn.Linear(time_embed_dim, 2 * latent_dim)
        self.norm = layer_norm(latent_dim)
        self.out_proj = zero_init(nn.Linear(latent_dim, latent_dim))

    def forward(self, h: torch.Tensor, emb: torch.Tensor,
                drop: Optional[DropoutDraws] = None) -> torch.Tensor:
        scale, shift = self.emb_layer(Fn.silu(emb))[:, None].chunk(2, dim=-1)
        h = self.norm(h) * (1 + scale) + shift
        return self.out_proj(dropout(drop, Fn.silu(h), self.dropout))


class FFN(nn.Module):
    """Feed-forward (exact GELU, then dropout) with zero-init second linear
    and a stylized residual."""

    def __init__(self, latent_dim: int, ffn_dim: int, time_embed_dim: int,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.linear1 = nn.Linear(latent_dim, ffn_dim)
        self.linear2 = zero_init(nn.Linear(ffn_dim, latent_dim))
        self.proj_out = StylizationBlock(latent_dim, time_embed_dim, dropout)

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                drop: Optional[DropoutDraws] = None) -> torch.Tensor:
        y = self.linear2(dropout(drop, Fn.gelu(self.linear1(x)),
                                 self.dropout))
        return x + self.proj_out(y, emb, drop)


def strided_token_mask(frame_mask: torch.Tensor,
                       chunk_size: int) -> torch.Tensor:
    """Frame mask (B, T_frames) -> 43-token-layout mask (B, 4L+3): stride
    by the chunk size and tile 4x with zero separators."""
    m = frame_mask[:, ::chunk_size]
    sep = torch.zeros_like(m[:, :1])
    return torch.cat([m, sep, m, sep, m, sep, m], dim=1)
