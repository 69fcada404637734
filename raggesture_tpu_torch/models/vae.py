"""Body-part Transformer-VAEs, the frozen latent codec under the diffusion.
Port of the decode path of ``raggesture_tpu/models/vae.py`` for the shipped
``all_encoder`` decoder (post-norm layers, exact GELU, learned positions).

decode: z (B, 10, 512) + 150 zero queries -> skip-connected encoder stack
with ``num_heads * 8`` heads -> (B, 150, nfeats).  Replicated quirk: the
decoder passes ``pos = PE(xseq)`` = xseq + pe and every layer adds it to
q/k again, so the position table enters twice.

The encoder's parameters are held so that a JAX checkpoint loads whole;
the encode path itself is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as Fn
from torch import nn

from ..ops.mha import fused_softmax_mha
from .layers import layer_norm


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    nfeats: int
    latent_dim: int = 512
    num_layers: int = 8
    num_heads: int = 4
    ff_size: int = 1024
    dropout: float = 0.1
    activation: str = "gelu"
    normalize_before: bool = False
    position_embedding: str = "learned"
    decoder_arch: str = "all_encoder"
    vae_dist: str = "normal"
    frame_chunk_size: int = 15
    num_frames: int = 150
    pe_max_len: int = 1024


class PositionalEmbedding(nn.Module):
    """Learned position table ``pe`` (max_len, d_model); returns x + pe[:T]."""

    def __init__(self, d_model: int, max_len: int = 1024):
        super().__init__()
        self.pe = nn.Parameter(torch.empty(max_len, d_model))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.pe[None, :x.shape[1]]


class TorchMHA(nn.Module):
    """torch.nn.MultiheadAttention semantics (separate q/k/v projections +
    out projection), unmasked, inference only: the attention itself is
    kernel K2 (``ops.mha.fused_softmax_mha``)."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, q, k, v):
        D = q.shape[-1]
        out = fused_softmax_mha(self.q_proj(q), self.k_proj(k), self.v_proj(v),
                                self.num_heads,
                                1.0 / math.sqrt(D // self.num_heads))
        return self.out_proj(out)


class EncoderLayer(nn.Module):
    """Post-norm torch TransformerEncoderLayer; ``pos`` goes to q/k only."""

    def __init__(self, cfg: VAEConfig, num_heads: int):
        super().__init__()
        D = cfg.latent_dim
        self.self_attn = TorchMHA(D, num_heads)
        self.linear1 = nn.Linear(D, cfg.ff_size)
        self.linear2 = nn.Linear(cfg.ff_size, D)
        self.norm1 = layer_norm(D)
        self.norm2 = layer_norm(D)

    def forward(self, x, pos=None):
        qk = x if pos is None else x + pos
        x = self.norm1(x + self.self_attn(qk, qk, x))
        return self.norm2(x + self.linear2(Fn.gelu(self.linear1(x))))


class SkipTransformerEncoder(nn.Module):
    """U-Net-arranged encoder stack with cat + linear skip merges;
    num_layers is rounded up to odd."""

    def __init__(self, cfg: VAEConfig, num_layers: int, num_heads: int):
        super().__init__()
        n = num_layers + (1 if num_layers % 2 == 0 else 0)
        self.num_block = (n - 1) // 2
        D = cfg.latent_dim
        for i in range(self.num_block):
            setattr(self, f"input_{i}", EncoderLayer(cfg, num_heads))
        self.middle = EncoderLayer(cfg, num_heads)
        for i in range(self.num_block):
            setattr(self, f"skip_linear_{i}", nn.Linear(2 * D, D))
            setattr(self, f"output_{i}", EncoderLayer(cfg, num_heads))
        self.final_norm = layer_norm(D)

    def forward(self, x, pos=None):
        xs = []
        for i in range(self.num_block):
            x = getattr(self, f"input_{i}")(x, pos)
            xs.append(x)
        x = self.middle(x, pos)
        for i in range(self.num_block):
            x = getattr(self, f"skip_linear_{i}")(torch.cat([x, xs.pop()], -1))
            x = getattr(self, f"output_{i}")(x, pos)
        return self.final_norm(x)


class TransformerVAE(nn.Module):
    """One body part's chunked VAE (decode path)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        if (cfg.decoder_arch != "all_encoder" or cfg.normalize_before
                or cfg.activation != "gelu"
                or cfg.position_embedding != "learned"):
            raise NotImplementedError(
                "only the shipped VAE (all_encoder decoder, post-norm, GELU, "
                "learned positions) is ported")
        self.cfg = cfg
        D = cfg.latent_dim
        self.skel_embedding = nn.Linear(cfg.nfeats, D)
        self.final_layer = nn.Linear(D, cfg.nfeats)
        self.global_motion_token = nn.Parameter(torch.empty(2, D))
        self.query_pos_encoder = PositionalEmbedding(D, cfg.pe_max_len)
        self.query_pos_decoder = PositionalEmbedding(D, cfg.pe_max_len)
        self.encoder = SkipTransformerEncoder(cfg, cfg.num_layers,
                                              cfg.num_heads)
        self.decoder = SkipTransformerEncoder(cfg, cfg.num_layers,
                                              cfg.num_heads * 8)

    def decode(self, z: torch.Tensor,
               n_frames: Optional[int] = None) -> torch.Tensor:
        """(B, n_chunks, latent) -> (B, n_frames, nfeats)."""
        B, n_chunks, D = z.shape
        if n_frames is None:
            n_frames = n_chunks * self.cfg.frame_chunk_size
        queries = z.new_zeros(B, n_frames, D)
        xseq = torch.cat([z, queries], dim=1)
        query_pos = self.query_pos_decoder(xseq)   # the quirk: xseq + pe
        out = self.decoder(xseq, pos=query_pos)[:, n_chunks:]
        return self.final_layer(out)
