"""Body-part Transformer-VAEs, the frozen latent codec under the diffusion.
Port of ``raggesture_tpu/models/vae.py``: every variant the JAX package
builds, the decoder ``all_encoder`` (shipped) or ``encoder_decoder``,
post-norm (shipped) or pre-norm layers, GELU (shipped) or ReLU, learned
(shipped) or sine positions, and dropout.

encode: (B, 150, nfeats) -> (B*10, 15, nfeats) chunks, two distribution
tokens in front, a frame key-padding mask -> skip-connected encoder with
``num_heads`` heads -> (mu, logvar) of one latent token per chunk.
decode (``all_encoder``): z (B, 10, 512) + 150 zero queries ->
skip-connected encoder stack with ``num_heads * 8`` heads -> (B, 150,
nfeats).  Replicated quirk: the decoder passes ``pos = PE(xseq)`` = xseq +
pe and every layer adds it to q/k again, so the position table enters
twice.  decode (``encoder_decoder``): 150 positioned zero queries attend
to the positioned latents through a skip-connected stack of
``(num_layers - 1) * 4 + 1`` decoder layers with ``num_heads * 4`` heads.

Every unmasked attention at a shape kernel K2 takes runs K2
(``ops/mha.py::fused_softmax_mha``, under autograd its forward with the
plain recompute as backward, as in the JAX package); a masked call, an
attention under dropout or a shape K2 refuses takes the plain einsum.
Dropout is applied only where a ``DropoutDraws`` (``layers.py``) is given,
the JAX package's ``deterministic=False``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as Fn
from torch import nn

from ..ops.mha import fused_softmax_mha, mha_supported
from .layers import DropoutDraws, dropout, layer_norm, sine_position_table


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


def _activation(name: str):
    if name == "gelu":
        return Fn.gelu          # exact, as the JAX package's
    if name == "relu":
        return Fn.relu
    raise ValueError(name)


class PositionalEmbedding(nn.Module):
    """x + pe[:T]: a learned table ``pe`` (max_len, d_model), or with
    ``kind="sine"`` the DETR sine table (a buffer, no parameter)."""

    def __init__(self, d_model: int, max_len: int = 1024,
                 kind: str = "learned"):
        super().__init__()
        if kind == "learned":
            self.pe = nn.Parameter(torch.empty(max_len, d_model))
        elif kind == "sine":
            self.register_buffer("pe", sine_position_table(max_len, d_model),
                                 persistent=False)
        else:
            raise ValueError(f"position embedding {kind!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.pe[None, :x.shape[1]]


def attend(qd: torch.Tensor, kd: torch.Tensor, vd: torch.Tensor,
           num_heads: int, key_padding_mask=None,
           drop: Optional[DropoutDraws] = None,
           rate: float = 0.0) -> torch.Tensor:
    """Softmax attention of projected q (B, Tq, D), k/v (B, Tk, D) per head.
    Unmasked and without dropout, at shapes the kernel takes
    (``ops.mha.mha_supported``), it is kernel K2
    (``ops.mha.fused_softmax_mha``).  Otherwise it is the plain einsum, with
    a -1e9 logit bias on padded keys when a key-padding mask (B, Tk), True
    where the key is valid, is given (the encode path), and dropout at
    ``rate`` on the attention weights when ``drop`` is given: the JAX
    package's own route for a masked call, dropout, or a shape its kernel
    does not take."""
    B, Tq, D = qd.shape
    H = num_heads
    Dh = D // H
    dropping = drop is not None and rate > 0.0
    if (key_padding_mask is None and not dropping
            and mha_supported(Tq, kd.shape[1], D, H)):
        return fused_softmax_mha(qd, kd, vd, H, 1.0 / math.sqrt(Dh))
    logits = torch.einsum("bqhd,bkhd->bhqk", qd.reshape(B, Tq, H, Dh),
                          kd.reshape(B, -1, H, Dh)) / math.sqrt(Dh)
    if key_padding_mask is not None:
        # in the logits' dtype, as jnp's weakly typed where(mask, 0., -1e9)
        logits = logits + torch.where(
            key_padding_mask[:, None, None, :], 0.0, -1e9).to(logits.dtype)
    w = dropout(drop, torch.softmax(logits, dim=-1), rate)
    return torch.einsum("bhqk,bkhd->bqhd", w,
                        vd.reshape(B, -1, H, Dh)).reshape(B, Tq, D)


class TorchMHA(nn.Module):
    """torch.nn.MultiheadAttention semantics (separate q/k/v projections +
    out projection); the attention is :func:`attend`, its weights dropped
    at ``dropout`` under a ``drop``."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, q, k, v, key_padding_mask=None, drop=None):
        """q (B, Tq, D), k/v (B, Tk, D); key_padding_mask (B, Tk), True
        where the key is valid."""
        return self.out_proj(attend(self.q_proj(q), self.k_proj(k),
                                    self.v_proj(v), self.num_heads,
                                    key_padding_mask, drop, self.dropout))


class EncoderLayer(nn.Module):
    """torch TransformerEncoderLayer, post-norm or (``normalize_before``)
    pre-norm; ``pos`` goes to q/k only."""

    def __init__(self, cfg: VAEConfig, num_heads: int):
        super().__init__()
        D = cfg.latent_dim
        self.cfg = cfg
        self.act = _activation(cfg.activation)
        self.self_attn = TorchMHA(D, num_heads, cfg.dropout)
        self.linear1 = nn.Linear(D, cfg.ff_size)
        self.linear2 = nn.Linear(cfg.ff_size, D)
        self.norm1 = layer_norm(D)
        self.norm2 = layer_norm(D)

    def forward(self, x, pos=None, key_padding_mask=None, drop=None):
        r = self.cfg.dropout

        def attn(xin):
            qk = xin if pos is None else xin + pos
            return self.self_attn(qk, qk, xin, key_padding_mask, drop)

        def ff(xin):
            return self.linear2(dropout(drop, self.act(self.linear1(xin)), r))

        if self.cfg.normalize_before:
            x = x + dropout(drop, attn(self.norm1(x)), r)
            return x + dropout(drop, ff(self.norm2(x)), r)
        x = self.norm1(x + dropout(drop, attn(x), r))
        return self.norm2(x + dropout(drop, ff(x), r))


class DecoderLayerTorch(nn.Module):
    """torch TransformerDecoderLayer (the ``encoder_decoder`` decode):
    self-attention, cross attention to the memory, FFN; post- or pre-norm.
    ``query_pos`` goes to the queries' q/k, ``pos`` to the memory's keys."""

    def __init__(self, cfg: VAEConfig, num_heads: int):
        super().__init__()
        D = cfg.latent_dim
        self.cfg = cfg
        self.act = _activation(cfg.activation)
        self.self_attn = TorchMHA(D, num_heads, cfg.dropout)
        self.multihead_attn = TorchMHA(D, num_heads, cfg.dropout)
        self.linear1 = nn.Linear(D, cfg.ff_size)
        self.linear2 = nn.Linear(cfg.ff_size, D)
        self.norm1 = layer_norm(D)
        self.norm2 = layer_norm(D)
        self.norm3 = layer_norm(D)

    def forward(self, tgt, memory, pos=None, query_pos=None,
                tgt_key_padding_mask=None, memory_key_padding_mask=None,
                drop=None):
        r = self.cfg.dropout

        def add_pos(t, p):
            return t if p is None else t + p

        def sa(xin):
            qk = add_pos(xin, query_pos)
            return self.self_attn(qk, qk, xin, tgt_key_padding_mask, drop)

        def ca(xin):
            return self.multihead_attn(add_pos(xin, query_pos),
                                       add_pos(memory, pos), memory,
                                       memory_key_padding_mask, drop)

        def ff(xin):
            return self.linear2(dropout(drop, self.act(self.linear1(xin)), r))

        if self.cfg.normalize_before:
            tgt = tgt + dropout(drop, sa(self.norm1(tgt)), r)
            tgt = tgt + dropout(drop, ca(self.norm2(tgt)), r)
            return tgt + dropout(drop, ff(self.norm3(tgt)), r)
        tgt = self.norm1(tgt + dropout(drop, sa(tgt), r))
        tgt = self.norm2(tgt + dropout(drop, ca(tgt), r))
        return self.norm3(tgt + dropout(drop, ff(tgt), r))


class _SkipStack(nn.Module):
    """U-Net-arranged stack of ``layer`` modules with cat + linear skip
    merges; num_layers is rounded up to odd."""

    def __init__(self, cfg: VAEConfig, num_layers: int, num_heads: int,
                 layer):
        super().__init__()
        n = num_layers + (1 if num_layers % 2 == 0 else 0)
        self.num_block = (n - 1) // 2
        D = cfg.latent_dim
        for i in range(self.num_block):
            setattr(self, f"input_{i}", layer(cfg, num_heads))
        self.middle = layer(cfg, num_heads)
        for i in range(self.num_block):
            setattr(self, f"skip_linear_{i}", nn.Linear(2 * D, D))
            setattr(self, f"output_{i}", layer(cfg, num_heads))
        self.final_norm = layer_norm(D)

    def _run(self, x, call):
        xs = []
        for i in range(self.num_block):
            x = call(getattr(self, f"input_{i}"), x)
            xs.append(x)
        x = call(self.middle, x)
        for i in range(self.num_block):
            x = getattr(self, f"skip_linear_{i}")(torch.cat([x, xs.pop()], -1))
            x = call(getattr(self, f"output_{i}"), x)
        return self.final_norm(x)


class SkipTransformerEncoder(_SkipStack):
    """The skip-connected stack of :class:`EncoderLayer`."""

    def __init__(self, cfg: VAEConfig, num_layers: int, num_heads: int):
        super().__init__(cfg, num_layers, num_heads, EncoderLayer)

    def forward(self, x, pos=None, key_padding_mask=None, drop=None):
        return self._run(x, lambda layer, h: layer(h, pos, key_padding_mask,
                                                   drop))


class SkipTransformerDecoder(_SkipStack):
    """The skip-connected stack of :class:`DecoderLayerTorch` over a
    memory."""

    def __init__(self, cfg: VAEConfig, num_layers: int, num_heads: int):
        super().__init__(cfg, num_layers, num_heads, DecoderLayerTorch)

    def forward(self, tgt, memory, pos=None, query_pos=None,
                tgt_key_padding_mask=None, drop=None):
        return self._run(tgt, lambda layer, h: layer(
            h, memory, pos, query_pos, tgt_key_padding_mask, drop=drop))


class TransformerVAE(nn.Module):
    """One body part's chunked VAE."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        if cfg.decoder_arch not in ("all_encoder", "encoder_decoder"):
            raise ValueError(f"decoder_arch {cfg.decoder_arch!r}")
        _activation(cfg.activation)
        self.cfg = cfg
        D = cfg.latent_dim
        kind = cfg.position_embedding
        self.skel_embedding = nn.Linear(cfg.nfeats, D)
        self.final_layer = nn.Linear(D, cfg.nfeats)
        self.global_motion_token = nn.Parameter(torch.empty(2, D))
        self.query_pos_encoder = PositionalEmbedding(D, cfg.pe_max_len, kind)
        self.query_pos_decoder = PositionalEmbedding(D, cfg.pe_max_len, kind)
        self.encoder = SkipTransformerEncoder(cfg, cfg.num_layers,
                                              cfg.num_heads)
        if cfg.decoder_arch == "all_encoder":
            self.decoder = SkipTransformerEncoder(cfg, cfg.num_layers,
                                                  cfg.num_heads * 8)
        else:
            self.mem_pos_decoder = PositionalEmbedding(D, cfg.pe_max_len,
                                                       kind)
            self.decoder = SkipTransformerDecoder(
                cfg, (cfg.num_layers - 1) * 4 + 1, cfg.num_heads * 4)

    def encode_dist(self, features: torch.Tensor,
                    frame_mask: Optional[torch.Tensor] = None,
                    drop: Optional[DropoutDraws] = None):
        """(B, n_frames, nfeats) -> (mu, logvar), each (B, n_chunks, D)."""
        c = self.cfg
        B, n_frames, nfeats = features.shape
        n_chunks = n_frames // c.frame_chunk_size
        x = self.skel_embedding(
            features.reshape(B * n_chunks, c.frame_chunk_size, nfeats))
        tokens = self.global_motion_token[None].expand(B * n_chunks, -1, -1)
        xseq = self.query_pos_encoder(torch.cat([tokens, x], dim=1))
        aug = None
        if frame_mask is not None:
            m = frame_mask.reshape(B * n_chunks, c.frame_chunk_size) > 0
            aug = torch.cat([torch.ones_like(m[:, :2]), m], dim=1)
        latent = self.encoder(xseq, key_padding_mask=aug, drop=drop)[:, :2]
        return (latent[:, 0].reshape(B, n_chunks, -1),
                latent[:, 1].reshape(B, n_chunks, -1))

    def encode_to_dist(self, features: torch.Tensor,
                       eps: Optional[torch.Tensor] = None,
                       frame_mask: Optional[torch.Tensor] = None,
                       drop: Optional[DropoutDraws] = None):
        """(z, (mu, logvar)): z = mu + exp(logvar / 2) eps, the reference's
        rsample at encode, with the draw ``eps`` (B, n_chunks, D) given;
        z = mu without it."""
        mu, logvar = self.encode_dist(features, frame_mask, drop)
        z = mu if eps is None else mu + torch.exp(0.5 * logvar) * eps
        return z, (mu, logvar)

    def decode(self, z: torch.Tensor, n_frames: Optional[int] = None,
               drop: Optional[DropoutDraws] = None) -> torch.Tensor:
        """(B, n_chunks, latent) -> (B, n_frames, nfeats)."""
        B, n_chunks, D = z.shape
        if n_frames is None:
            n_frames = n_chunks * self.cfg.frame_chunk_size
        queries = z.new_zeros(B, n_frames, D)
        if self.cfg.decoder_arch == "all_encoder":
            xseq = torch.cat([z, queries], dim=1)
            query_pos = self.query_pos_decoder(xseq)   # the quirk: xseq + pe
            out = self.decoder(xseq, pos=query_pos, drop=drop)[:, n_chunks:]
        else:
            out = self.decoder(self.query_pos_decoder(queries),
                               self.mem_pos_decoder(z), drop=drop)
        return self.final_layer(out)
