"""Standard softmax attention blocks: ``BaseSelfAttention``,
``BaseCrossAttention`` and ``BaseMixedAttention``, with the interface of
the denoiser's linear ("efficient") blocks: masked keys, a stylized
residual.  Port of ``raggesture_tpu/models/base_attention.py``.

These are library modules, alternatives to the linear attention for
experiments: no configuration builds them into the denoiser.  The
attention is plain PyTorch (matmul, softmax, matmul), as the JAX package
computes it outside Pallas.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.linear_attention import NEG_MASK
from .layers import DropoutDraws, StylizationBlock, layer_norm


def _softmax_attention(q, k, v, num_heads: int, key_bias=None):
    """q (B, T, D), k and v (B, N, D) -> (B, T, D): scaled dot-product
    attention per head, ``key_bias`` added to the (B, H, T, N) logits."""
    B, T, D = q.shape
    N = k.shape[1]
    Dh = D // num_heads
    qh = q.reshape(B, T, num_heads, Dh)
    kh = k.reshape(B, N, num_heads, Dh)
    vh = v.reshape(B, N, num_heads, Dh)
    logits = torch.einsum("bthd,bnhd->bhtn", qh, kh) / math.sqrt(Dh)
    if key_bias is not None:
        logits = logits + key_bias
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhtn,bnhd->bthd", w, vh).reshape(B, T, D)


def _cond_bias(cond_mask, B: int, N: int):
    """(B, 1, 1) condition mask -> (B, 1, 1, N) key bias, -1e6 on every key
    of a dropped condition."""
    return ((1.0 - cond_mask) * NEG_MASK).reshape(B, 1, 1, 1).expand(
        B, 1, 1, N)


class BaseSelfAttention(nn.Module):
    """Softmax self-attention with masked keys and a stylized residual."""

    def __init__(self, latent_dim: int, num_heads: int, time_embed_dim: int,
                 dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.norm = layer_norm(latent_dim)
        self.query = nn.Linear(latent_dim, latent_dim)
        self.key = nn.Linear(latent_dim, latent_dim)
        self.value = nn.Linear(latent_dim, latent_dim)
        self.proj_out = StylizationBlock(latent_dim, time_embed_dim, dropout)

    def forward(self, x, src_mask, emb, drop: Optional[DropoutDraws] = None):
        """x (B, T, D), src_mask (B, T, 1), emb (B, TE)."""
        xn = self.norm(x)
        key_bias = ((1.0 - src_mask).transpose(1, 2)[:, None] * NEG_MASK)
        y = _softmax_attention(self.query(xn), self.key(xn), self.value(xn),
                               self.num_heads, key_bias)
        return x + self.proj_out(y, emb, drop)


class BaseCrossAttention(nn.Module):
    """Softmax cross-attention over condition features (B, N, Dc), with the
    condition mask and an output query mask, and a stylized residual."""

    def __init__(self, latent_dim: int, num_heads: int, time_embed_dim: int,
                 dropout: float = 0.0, cond_dim: Optional[int] = None):
        super().__init__()
        Dc = latent_dim if cond_dim is None else cond_dim
        self.num_heads = num_heads
        self.norm = layer_norm(latent_dim)
        self.text_norm = layer_norm(Dc)
        self.query = nn.Linear(latent_dim, latent_dim)
        self.key = nn.Linear(Dc, latent_dim)
        self.value = nn.Linear(Dc, latent_dim)
        self.proj_out = StylizationBlock(latent_dim, time_embed_dim, dropout)

    def forward(self, x, xf, emb, query_mask=None, cond_mask=None,
                drop: Optional[DropoutDraws] = None):
        """x (B, T, D), xf (B, N, Dc), emb (B, TE), query_mask (B, T),
        cond_mask (B, 1, 1): a dropped condition's keys all get -1e6 (its
        softmax is then uniform) and its values are the value bias."""
        B, T, _ = x.shape
        xn = self.norm(x)
        xfn = self.text_norm(xf)
        key_bias = None
        if cond_mask is not None:
            v = self.value(xfn * cond_mask)
            key_bias = _cond_bias(cond_mask, B, xf.shape[1])
        else:
            v = self.value(xfn)
        y = _softmax_attention(self.query(xn), self.key(xfn), v,
                               self.num_heads, key_bias)
        if query_mask is not None:
            y = y * query_mask.reshape(B, T, 1)
        return x + self.proj_out(y, emb, drop)


class BaseMixedAttention(nn.Module):
    """Joint self- and cross-attention: the queries of x attend over the
    concatenated [xf; x] keys and values, and a stylized residual."""

    def __init__(self, latent_dim: int, num_heads: int, time_embed_dim: int,
                 dropout: float = 0.0, cond_dim: Optional[int] = None):
        super().__init__()
        Dc = latent_dim if cond_dim is None else cond_dim
        self.num_heads = num_heads
        self.norm = layer_norm(latent_dim)
        self.text_norm = layer_norm(Dc)
        self.query = nn.Linear(latent_dim, latent_dim)
        self.key_text = nn.Linear(Dc, latent_dim)
        self.key_motion = nn.Linear(latent_dim, latent_dim)
        self.value_text = nn.Linear(Dc, latent_dim)
        self.value_motion = nn.Linear(latent_dim, latent_dim)
        self.proj_out = StylizationBlock(latent_dim, time_embed_dim, dropout)

    def forward(self, x, xf, emb, src_mask=None, cond_mask=None,
                drop: Optional[DropoutDraws] = None):
        """x (B, T, D), xf (B, N, Dc), emb (B, TE), src_mask (B, T, 1),
        cond_mask (B, 1, 1)."""
        B, T, _ = x.shape
        N = xf.shape[1]
        xn = self.norm(x)
        xfn = self.text_norm(xf)
        k = torch.cat([self.key_text(xfn), self.key_motion(xn)], dim=1)
        v = torch.cat([
            self.value_text(xfn if cond_mask is None else xfn * cond_mask),
            self.value_motion(xn if src_mask is None else xn * src_mask),
        ], dim=1)
        bias_text = (x.new_zeros(B, 1, 1, N) if cond_mask is None
                     else _cond_bias(cond_mask, B, N))
        bias_motion = (x.new_zeros(B, 1, 1, T) if src_mask is None
                       else ((1.0 - src_mask) * NEG_MASK).transpose(1, 2)
                       [:, None])
        y = _softmax_attention(self.query(xn), k, v, self.num_heads,
                               torch.cat([bias_text, bias_motion], dim=-1))
        return x + self.proj_out(y, emb, drop)
