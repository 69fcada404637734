"""The gesture diffusion denoiser, eager.  Port of
``raggesture_tpu/models/denoiser.py``, with the optional learned condition
encoders (``CondTransformerEncoder``, text or audio ``num_layers > 0``).

An 8-layer decoder over the 43-token body-part latent sequence: linear
self-attention, three parallel linear cross-attentions over the text, audio
and speaker conditions, a mixing linear and an adaLN-stylized FFN, all
modulated by the timestep embedding.  This module holds the weights and is
the oracle for the fused sampling path (``fused_denoiser.py``).

Replicated quirks of the reference:
  - cross-attention adds ``(1 - query_mask) * -1e6`` to its *output*, and
    the default query masks sit at [L, 2L, 3L] = [10, 20, 30], not at the
    true separators [10, 21, 32] (``default_query_masks``);
  - masked cross-attention values are ``value(norm(xf) * cond_mask)``, so
    the value bias survives the condition mask;
  - the output head and every stylization/FFN second linear are zero-init.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as Fn
from torch import nn

from ..ops.linear_attention import (
    NEG_MASK,
    feature_softmax_q,
    linear_attention,
    time_softmax_k,
)
from .layers import (
    FFN,
    DropoutDraws,
    LearnedPositionEmbedding,
    StylizationBlock,
    layer_norm,
    sine_position_table,
    strided_token_mask,
    timestep_embedding,
    zero_init,
)

COND_KEYS = ("xf_text", "xf_audio", "xf_spk")


@dataclasses.dataclass(frozen=True)
class DenoiserConfig:
    """The shipped basegesture_len150_beat denoiser (same defaults as the
    JAX package's DenoiserConfig)."""

    latent_dim: int = 512
    time_embed_dim: int = 2048
    num_layers: int = 8
    num_heads: int = 16
    ff_size: int = 1024
    dropout: float = 0.0
    ca_num_heads: int = 0
    ca_dropout: float = -1.0
    text_latent_dim: int = 768
    audio_latent_dim: int = 768
    num_speakers: int = 25
    max_seq_len: int = 150
    frame_chunk_size: int = 15
    num_parts: int = 4
    text_num_layers: int = 0
    audio_num_layers: int = 0
    cond_enc_heads: int = 4
    cond_enc_ff: int = 2048

    @property
    def ca_heads(self) -> int:
        return self.ca_num_heads if self.ca_num_heads > 0 else self.num_heads

    @property
    def ca_drop(self) -> float:
        return self.ca_dropout if self.ca_dropout >= 0 else self.dropout

    @property
    def tokens_per_part(self) -> int:
        return self.max_seq_len // self.frame_chunk_size

    @property
    def num_tokens(self) -> int:
        return self.num_parts * self.tokens_per_part + (self.num_parts - 1)

    @property
    def sep_indices(self) -> tuple:
        """The TRUE separator token positions in the 43-token layout."""
        L = self.tokens_per_part
        return (L, 2 * L + 1, 3 * L + 2)

    @property
    def quirk_sep_indices(self) -> tuple:
        """The reference's query-mask indices [L, 2L, 3L] (two of them are
        valid tokens); checkpoint parity needs them."""
        L = self.tokens_per_part
        return (L, 2 * L, 3 * L)

    def part_slices(self) -> Dict[str, slice]:
        L = self.tokens_per_part
        return {
            "upper": slice(0, L),
            "hands": slice(L + 1, 2 * L + 1),
            "face": slice(2 * L + 2, 3 * L + 2),
            "lowertrans": slice(3 * L + 3, 4 * L + 3),
        }


class EfficientSelfAttention(nn.Module):
    """Linear self-attention with a stylized residual (its dropout in the
    stylization block)."""

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
        B, T, D = x.shape
        H = self.num_heads
        xn = self.norm(x)
        q = feature_softmax_q(self.query(xn).reshape(B, T, H, -1))
        k = time_softmax_k(self.key(xn) + (1.0 - src_mask) * NEG_MASK)
        v = self.value(xn) * src_mask
        y = linear_attention(q, k, v, H).reshape(B, T, D)
        return x + self.proj_out(y, emb, drop)


class EfficientCrossAttention(nn.Module):
    """Linear cross-attention with condition dropout and the output-side
    query-mask quirk (its dropout in the stylization block)."""

    def __init__(self, latent_dim: int, num_heads: int, time_embed_dim: int,
                 dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.norm = layer_norm(latent_dim)
        self.text_norm = layer_norm(latent_dim)
        self.query = nn.Linear(latent_dim, latent_dim)
        self.key = nn.Linear(latent_dim, latent_dim)
        self.value = nn.Linear(latent_dim, latent_dim)
        self.proj_out = StylizationBlock(latent_dim, time_embed_dim, dropout)

    def forward(self, x, xf, emb, query_mask=None, cond_mask=None,
                drop: Optional[DropoutDraws] = None):
        # x: (B, T, D); xf: (B, N, D); query_mask: (B, T); cond_mask (B, 1, 1)
        B, T, D = x.shape
        H = self.num_heads
        xn = self.norm(x)
        xfn = self.text_norm(xf)
        q = feature_softmax_q(self.query(xn).reshape(B, T, H, -1))
        k = self.key(xfn)
        if cond_mask is not None:
            k = k + (1.0 - cond_mask) * NEG_MASK
            v = self.value(xfn * cond_mask)
        else:
            v = self.value(xfn)
        y = linear_attention(q, time_softmax_k(k), v, H)
        if query_mask is not None:
            y = y + (1.0 - query_mask).reshape(B, T, 1, 1) * NEG_MASK
        return x + self.proj_out(y.reshape(B, T, D), emb, drop)


class DecoderLayer(nn.Module):
    """self-attn -> 3 parallel cross-attns -> concat -> mix -> FFN; the
    cross attentions drop at ``ca_drop``, the rest at ``dropout``."""

    def __init__(self, cfg: DenoiserConfig):
        super().__init__()
        D, TE = cfg.latent_dim, cfg.time_embed_dim
        self.sa_block = EfficientSelfAttention(D, cfg.num_heads, TE,
                                               cfg.dropout)
        for key in COND_KEYS:
            setattr(self, f"ca_{key}",
                    EfficientCrossAttention(D, cfg.ca_heads, TE,
                                            cfg.ca_drop))
        self.ca_mix = nn.Linear(3 * D, D)
        self.ffn = FFN(D, cfg.ff_size, TE, cfg.dropout)

    def forward(self, x, conds, emb, src_mask, query_masks, cond_mask,
                drop: Optional[DropoutDraws] = None):
        x = self.sa_block(x, src_mask, emb, drop)
        outs = [getattr(self, f"ca_{key}")(
                    x, conds[key], emb,
                    query_mask=None if query_masks is None else query_masks[key],
                    cond_mask=cond_mask, drop=drop)
                for key in COND_KEYS]
        return self.ffn(self.ca_mix(torch.cat(outs, dim=-1)), emb, drop)


class MultiHeadAttention(nn.Module):
    """flax's ``MultiHeadDotProductAttention`` over one sequence, unmasked:
    query, key and value projections to H heads, the query scaled by
    1/sqrt(Dh), a softmax over the keys, dropout on the attention weights
    with one (1, 1, N, N) keep mask shared by every row and head
    (``broadcast_dropout``), and the output projection.  The projections are
    (D, D) Linears; flax's (D, H, Dh) / (H, Dh, D) kernels reach them
    through ``utils/convert_jax.py``."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, x, drop: Optional[DropoutDraws] = None):
        B, N, D = x.shape
        H = self.num_heads
        Dh = D // H
        q = self.query(x).reshape(B, N, H, Dh)
        q = q / q.new_full((), Dh).sqrt()
        k = self.key(x).reshape(B, N, H, Dh)
        v = self.value(x).reshape(B, N, H, Dh)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        if drop is not None:
            w = drop.shared(w, self.dropout, (1, 1, N, N))
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, N, D))


class CondTransformerEncoder(nn.Module):
    """The optional encoder over a condition stream's projected features
    (B, N, D): ``num_layers`` post-norm layers, each self-attention over the
    whole sequence (no mask), residual and LayerNorm, then an exact-GELU
    FFN, residual and LayerNorm; a final LayerNorm.  Its one dropout is on
    the attention weights (see ``MultiHeadAttention``)."""

    def __init__(self, num_layers: int, d_model: int, num_heads: int,
                 ff_dim: int, dropout: float = 0.0):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"attn_{i}",
                    MultiHeadAttention(d_model, num_heads, dropout))
            setattr(self, f"norm1_{i}", layer_norm(d_model))
            setattr(self, f"ff1_{i}", nn.Linear(d_model, ff_dim))
            setattr(self, f"ff2_{i}", nn.Linear(ff_dim, d_model))
            setattr(self, f"norm2_{i}", layer_norm(d_model))
        self.final_norm = layer_norm(d_model)

    def forward(self, x, drop: Optional[DropoutDraws] = None):
        for i in range(self.num_layers):
            x = getattr(self, f"norm1_{i}")(
                x + getattr(self, f"attn_{i}")(x, drop))
            y = getattr(self, f"ff2_{i}")(Fn.gelu(getattr(self, f"ff1_{i}")(x)))
            x = getattr(self, f"norm2_{i}")(x + y)
        return self.final_norm(x)


class GestureDenoiser(nn.Module):
    """Condition projections (and the optional condition encoders) +
    token/position embeddings + the decoder stack + the zero-init output
    head."""

    def __init__(self, cfg: DenoiserConfig = DenoiserConfig()):
        super().__init__()
        self.cfg = cfg
        D, TE = cfg.latent_dim, cfg.time_embed_dim
        self.joint_embed = nn.Linear(D, D)
        self.time_embed_1 = nn.Linear(D, TE)
        self.time_embed_2 = nn.Linear(TE, TE)
        self.text_pre_proj = nn.Linear(cfg.text_latent_dim, D)
        self.audio_pre_proj = nn.Linear(cfg.audio_latent_dim, D)
        self.speaker_embedding = nn.Embedding(cfg.num_speakers, D)
        if cfg.text_num_layers > 0:
            self.text_encoder = CondTransformerEncoder(
                cfg.text_num_layers, D, cfg.cond_enc_heads, cfg.cond_enc_ff,
                cfg.dropout)
        if cfg.audio_num_layers > 0:
            self.audio_encoder = CondTransformerEncoder(
                cfg.audio_num_layers, D, cfg.cond_enc_heads, cfg.cond_enc_ff,
                cfg.dropout)
        self.global_positional_embedding = LearnedPositionEmbedding(
            cfg.num_tokens, D)
        for i in range(cfg.num_layers):
            setattr(self, f"block_{i}", DecoderLayer(cfg))
        self.out = zero_init(nn.Linear(D, D))

    def block(self, i: int) -> DecoderLayer:
        return getattr(self, f"block_{i}")

    def condition_encoders(self) -> Tuple[nn.Module, ...]:
        """The modules that read the raw condition features
        (``encode_conditions``): the projections, the speaker embedding and
        the condition encoders the config has."""
        return tuple(m for m in (
            self.text_pre_proj, self.audio_pre_proj, self.speaker_embedding,
            getattr(self, "text_encoder", None),
            getattr(self, "audio_encoder", None)) if m is not None)

    def encode_conditions(self, text_feats, audio_feats, speaker_ids,
                          drop: Optional[DropoutDraws] = None
                          ) -> Dict[str, torch.Tensor]:
        """Project raw condition features to the latent width:
        text (B, Nt, 768), audio (B, Na, 768), speaker ids (B,) or (B, 1);
        then the condition encoders, if any.  ``drop`` applies their
        attention dropout (flax's ``deterministic=False``); the training
        step, like the JAX package's, runs them without it."""
        if speaker_ids.dim() == 1:
            speaker_ids = speaker_ids[:, None]
        xf_text = self.text_pre_proj(text_feats)
        if self.cfg.text_num_layers > 0:
            xf_text = self.text_encoder(xf_text, drop)
        xf_audio = self.audio_pre_proj(audio_feats)
        if self.cfg.audio_num_layers > 0:
            xf_audio = self.audio_encoder(xf_audio, drop)
        return {"xf_text": xf_text, "xf_audio": xf_audio,
                "xf_spk": self.speaker_embedding(speaker_ids.long())}

    def time_embedding(self, timesteps: torch.Tensor) -> torch.Tensor:
        emb = timestep_embedding(timesteps, self.cfg.latent_dim)
        return self.time_embed_2(Fn.silu(self.time_embed_1(emb)))

    def embed_tokens(self, latents: torch.Tensor) -> torch.Tensor:
        """joint_embed + per-part sine positions with zero separators +
        learned global positions."""
        c = self.cfg
        T = latents.shape[1]
        pos = sine_position_table(c.tokens_per_part, c.latent_dim,
                                  device=latents.device)
        sep = torch.zeros_like(pos[:1])
        pos_cat = torch.cat([pos, sep, pos, sep, pos, sep, pos], dim=0)
        h = self.joint_embed(latents) + pos_cat[None, :T]
        return self.global_positional_embedding(h)

    def forward(self, latents, timesteps, motion_mask, conds,
                query_masks=None, cond_mask=None,
                drop: Optional[DropoutDraws] = None):
        """latents (B, 43, D), timesteps (B,) original-scale, motion_mask
        (B, 43), conds from encode_conditions, query_masks {key: (B, 43)},
        cond_mask (B, 1, 1) -> (B, 43, D) prediction (x0).  ``drop`` (the
        training forward's dropout draws) applies the config's dropout, in
        the JAX package's places; without it the call is deterministic.
        The layers here are plain PyTorch on any device: the kernels of
        the sampling paths (K1, K4-K8) run only through
        ``fused_denoiser.py``."""
        src_mask = motion_mask[..., None].to(latents.dtype)
        emb = self.time_embedding(timesteps)
        h = self.embed_tokens(latents)
        for i in range(self.cfg.num_layers):
            h = self.block(i)(h, conds, emb, src_mask, query_masks, cond_mask,
                              drop)
        return self.out(h)


def default_query_masks(cfg: DenoiserConfig, batch: int,
                        device=None) -> Dict[str, torch.Tensor]:
    """Ones except at the reference's quirk indices [L, 2L, 3L]."""
    m = torch.ones(batch, cfg.num_tokens, device=device)
    m[:, list(cfg.quirk_sep_indices)] = 0.0
    return {k: m for k in COND_KEYS}


def latent_motion_mask(cfg: DenoiserConfig,
                       frame_mask: torch.Tensor) -> torch.Tensor:
    """Frame mask (B, 150) -> token mask (B, 43)."""
    return strided_token_mask(frame_mask, cfg.frame_chunk_size)
