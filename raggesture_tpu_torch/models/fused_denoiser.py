"""The denoiser's fused paths: sampling through one DecoderLayer kernel per
layer or through the split blocks' kernels, the uncached denoiser call
(``fused_denoise``, below the split path), and training through the
all-layer condition-context kernels.

Port of ``raggesture_tpu/models/fused_denoiser.py::fused_denoise_ctx`` (its
layer-kernel branch and its split branch) and of the per-run precomputes
around it, and of ``train_denoise_ctx`` (at the end of this module).  The
eager ``GestureDenoiser`` holds the weights; this module re-lays them out
once per generator (``pack_layers`` or ``pack_split_layers``,
``adaln_table``) and once per run
(``precompute_cross_contexts``, ``stack_layer_contexts``,
``layer_kernel_mask_rows`` or ``split_mask_rows``), so that each of the
sampling loop's denoiser calls is an embedding, per layer either one
``ops.decoder_layer.fused_decoder_layer`` (bf16 packs) or the split
blocks' float32 kernels reading the modules' own weights
(``ops.self_attention``, ``ops.cross_attention``, ``ops.ffn``), and the
output head.

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

from typing import Callable, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as Fn

from ..ops.cond_ctx import cond_contexts
from ..ops.cross_attention import (
    CrossBlockWeights,
    fused_cross_attention,
    fused_cross_attention_cached,
    fused_cross_attention_cached_reference,
    fused_cross_attention_reference,
    fused_cross_block_cached,
    fused_cross_block_cached_reference,
    pack_cross_attention_kv,
    pack_cross_block,
)
from ..ops.decoder_layer import fused_decoder_layer, pack_decoder_layer
from ..ops.ffn import FFNWeights, fused_ffn, fused_ffn_reference, pack_ffn
from ..ops.linear_attention import (
    NEG_MASK,
    apply_context,
    feature_softmax_q,
    linear_attention_context,
    time_softmax_k,
)
from ..ops.self_attention import (
    SelfAttentionWeights,
    fused_self_attention,
    fused_self_attention_reference,
    pack_self_attention,
)
from .denoiser import COND_KEYS, DenoiserConfig, GestureDenoiser

STYL_SLOTS = ("sa", "xf_text", "xf_audio", "xf_spk", "ffn")


def _stylization(layer, slot: str):
    block = (layer.sa_block if slot == "sa" else
             layer.ffn if slot == "ffn" else getattr(layer, f"ca_{slot}"))
    return block.proj_out


@torch.no_grad()
def stack_adaln_weights(den: GestureDenoiser
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every stylization block's adaLN projection stacked as one Linear:
    W (num_layers·5·2D, TE) and b, layers then ``STYL_SLOTS``.  A copy of
    the weights (~336 MB at full width), made once per sampling run."""
    layers = [_stylization(den.block(i), s).emb_layer
              for i in range(den.cfg.num_layers) for s in STYL_SLOTS]
    return (torch.cat([e.weight for e in layers], dim=0),
            torch.cat([e.bias for e in layers], dim=0))


@torch.no_grad()
def stacked_adaln(den: GestureDenoiser, emb: torch.Tensor,
                  weights=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One product for every stylization block's (scale, shift): the time
    embeddings ``emb`` (B, TE) -> (scale, shift), each (B, num_layers, 5,
    D), views whose (B, D) slices have contiguous rows.  ``weights`` are
    ``stack_adaln_weights``' (stacked here when not given)."""
    c = den.cfg
    W, b = stack_adaln_weights(den) if weights is None else weights
    out = (Fn.silu(emb) @ W.t() + b).reshape(
        -1, c.num_layers, len(STYL_SLOTS), 2, c.latent_dim)
    return out[:, :, :, 0], out[:, :, :, 1]


@torch.no_grad()
def adaln_table(den: GestureDenoiser, t_all: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The adaLN rows of every sampling step: ``t_all`` (S,) original-scale
    timesteps -> (scale, shift), each (S, num_layers, 5, D) contiguous, the
    5 slots in ``STYL_SLOTS`` order."""
    scale, shift = stacked_adaln(den, den.time_embedding(t_all))
    return scale.contiguous(), shift.contiguous()


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


def split_mask_rows(motion_mask: torch.Tensor,
                    query_masks: Dict[str, torch.Tensor]):
    """The split path's once-per-run masks: (B, T, 1) token validity and
    (B, T, 3) query masks (a column view of it is each stream's)."""
    B, T = motion_mask.shape
    m = motion_mask.float().reshape(B, T, 1).contiguous()
    qm3 = torch.stack([query_masks[key].reshape(B, T).float()
                       for key in COND_KEYS], dim=-1).contiguous()
    return m, qm3


def pack_layers(den: GestureDenoiser, dtype: torch.dtype) -> tuple:
    return tuple(pack_decoder_layer(den.block(i), dtype)
                 for i in range(den.cfg.num_layers))


class SplitLayerWeights(NamedTuple):
    """One DecoderLayer's weight packs for the split path: the modules' own
    float32 tensors, not copies (``cross_block.cas`` are the three cross
    attentions' packs; its ``wmix``/``bmix`` are ca_mix)."""
    sa: SelfAttentionWeights
    cross_block: CrossBlockWeights
    ffn: FFNWeights


def pack_split_layer(layer) -> SplitLayerWeights:
    """The split path's weight packs of one ``models.denoiser.DecoderLayer``."""
    return SplitLayerWeights(
        pack_self_attention(layer.sa_block),
        pack_cross_block([getattr(layer, f"ca_{key}") for key in COND_KEYS],
                         layer.ca_mix),
        pack_ffn(layer.ffn))


def pack_split_layers(den: GestureDenoiser) -> tuple:
    """The split path's per-layer weight packs, built once per generator."""
    return tuple(pack_split_layer(den.block(i))
                 for i in range(den.cfg.num_layers))


class SplitFns(NamedTuple):
    """The split blocks' functions: the kernels' wrappers, or their plain
    versions for a comparison (``cross_attention`` is the uncached call's,
    ``fused_denoise``)."""
    self_attention: Callable
    cross_attention_cached: Callable
    cross_block_cached: Callable
    ffn: Callable
    cross_attention: Callable


SPLIT_KERNELS = SplitFns(fused_self_attention, fused_cross_attention_cached,
                         fused_cross_block_cached, fused_ffn,
                         fused_cross_attention)
SPLIT_PLAIN = SplitFns(fused_self_attention_reference,
                       fused_cross_attention_cached_reference,
                       fused_cross_block_cached_reference,
                       fused_ffn_reference, fused_cross_attention_reference)


@torch.no_grad()
def fused_denoise_ctx(den: GestureDenoiser, latents: torch.Tensor,
                      scale_rows: torch.Tensor, shift_rows: torch.Tensor,
                      packed_layers: tuple, ctx3_list: tuple,
                      mask_rows: torch.Tensor, qmask_rows: torch.Tensor,
                      layer_fn: Callable = fused_decoder_layer,
                      layer_kernel: bool = True, merged_ca: bool = False,
                      ffn_pallas: bool = False,
                      split_fns: SplitFns = SPLIT_KERNELS) -> torch.Tensor:
    """One denoiser call at a shared timestep: latents (B, T, D) ->
    prediction (B, T, D).  ``scale_rows``/``shift_rows`` are this step's
    (num_layers, 5, D) adaLN rows, shared by the batch.

    ``layer_kernel`` (checked first, as in the JAX package): each layer is
    one ``layer_fn`` call (the layer kernel's wrapper, or its plain version
    for a comparison) on padded rows, with ``packed_layers``, ``ctx3_list``
    in the packs' dtype and ``layer_kernel_mask_rows``' tables.

    Otherwise the split path, float32 throughout: ``packed_layers`` holds
    ``pack_split_layers``' packs, ``ctx3_list`` float32 (B, 3, H, Dh, Dh)
    contexts and ``mask_rows``/``qmask_rows`` are ``split_mask_rows``'
    (B, T, 1) and (B, T, 3).  Each layer runs the self-attention kernel,
    then with ``merged_ca`` the cross-block kernel, else the
    cross-attention kernel once per condition stream and ca_mix as a plain
    product; then the FFN kernel if ``ffn_pallas``, else the eager FFN.
    ``split_fns`` names the four block functions (``SPLIT_PLAIN`` for the
    plain versions)."""
    c = den.cfg
    B, T, D = latents.shape
    h = den.embed_tokens(latents)
    if layer_kernel:
        Tp = padded_tokens(T)
        h_rows = Fn.pad(h, (0, 0, 0, Tp - T)).reshape(B * Tp, D)
        for i in range(c.num_layers):
            h_rows = layer_fn(h_rows, mask_rows, qmask_rows, scale_rows[i],
                              shift_rows[i], ctx3_list[i], packed_layers[i],
                              c.num_heads, c.ca_heads, B)
        return den.out(h_rows.reshape(B, Tp, D)[:, :T])

    fns = split_fns
    for i, w in enumerate(packed_layers):
        # batch-uniform adaLN rows as (B, ...) views with batch stride 0
        sc, sh = scale_rows[i], shift_rows[i]
        h = fns.self_attention(h, mask_rows, sc[0].expand(B, D),
                               sh[0].expand(B, D), w.sa, c.num_heads)
        cb = w.cross_block
        if merged_ca:
            h = fns.cross_block_cached(
                h, ctx3_list[i], qmask_rows, sc[1:4].expand(B, 3, D),
                sh[1:4].expand(B, 3, D), cb, c.ca_heads)
        else:
            outs = [fns.cross_attention_cached(
                        h, ctx3_list[i][:, j], qmask_rows[..., j:j + 1],
                        sc[1 + j].expand(B, D), sh[1 + j].expand(B, D), ca,
                        c.ca_heads)
                    for j, ca in enumerate(cb.cas)]
            h = Fn.linear(torch.cat(outs, dim=-1), cb.wmix, cb.bmix)
        ffn = fns.ffn if ffn_pallas else fused_ffn_reference
        h = ffn(h, sc[4].expand(B, D), sh[4].expand(B, D), w.ffn)
    return den.out(h)


# ---------------------------------------------- the uncached denoiser call

class UnfusedLayerWeights(NamedTuple):
    """One DecoderLayer's weight packs for ``fused_denoise``: the modules'
    own float32 tensors (``cas``: the text, audio and speaker cross
    attentions' uncached packs; ``wmix``/``bmix``: ca_mix)."""
    sa: SelfAttentionWeights
    cas: tuple
    wmix: torch.Tensor
    bmix: torch.Tensor
    ffn: FFNWeights


def pack_unfused_layers(den: GestureDenoiser) -> tuple:
    """``fused_denoise``'s per-layer weight packs, built once per
    generator."""
    return tuple(UnfusedLayerWeights(
        pack_self_attention(layer.sa_block),
        tuple(pack_cross_attention_kv(getattr(layer, f"ca_{key}"))
              for key in COND_KEYS),
        layer.ca_mix.weight.detach(), layer.ca_mix.bias.detach(),
        pack_ffn(layer.ffn))
        for layer in (den.block(i) for i in range(den.cfg.num_layers)))


@torch.no_grad()
def fused_denoise(den: GestureDenoiser, latents: torch.Tensor,
                  t_orig: torch.Tensor, motion_mask: torch.Tensor,
                  conds: Dict[str, torch.Tensor], query_masks, cond_mask,
                  packed_layers: tuple = None, adaln_weights=None,
                  fns: SplitFns = SPLIT_KERNELS) -> torch.Tensor:
    """The uncached denoiser call, the kernel form of
    ``GestureDenoiser.forward`` with the same arguments: latents (B, T, D),
    per-sample original-scale timesteps ``t_orig`` (B,), token mask (B, T),
    the projected conditions, query masks {key: (B, T)} and ``cond_mask``
    (B, 1, 1) (None: ones) -> x0 prediction (B, T, D).

    Port of ``raggesture_tpu/models/fused_denoiser.py::fused_denoise``: the
    time embedding and every block's adaLN rows per call (one product,
    ``stacked_adaln``); per layer the self-attention kernel, the uncached
    cross-attention kernel once per condition stream (its keys and values
    from the condition rows, every call), ca_mix as a plain product and the
    eager FFN.  ``packed_layers`` (``pack_unfused_layers``) and
    ``adaln_weights`` (``stack_adaln_weights``) are built here when not
    given; ``fns`` names the block functions (``SPLIT_PLAIN`` for the
    plain versions)."""
    c = den.cfg
    B, T, D = latents.shape
    if packed_layers is None:
        packed_layers = pack_unfused_layers(den)
    src_mask = motion_mask.reshape(B, T, 1).to(latents.dtype)
    qms = ([latents.new_ones(B, T, 1)] * len(COND_KEYS) if query_masks is None
           else [query_masks[key].reshape(B, T, 1).to(latents.dtype)
                 for key in COND_KEYS])
    cm = (latents.new_ones(B, 1, 1) if cond_mask is None
          else cond_mask.reshape(B, 1, 1).to(latents.dtype))
    scale, shift = stacked_adaln(den, den.time_embedding(t_orig),
                                 adaln_weights)
    h = den.embed_tokens(latents)
    for i, w in enumerate(packed_layers):
        sc, sh = scale[:, i], shift[:, i]                  # (B, 5, D)
        h = fns.self_attention(h, src_mask, sc[:, 0], sh[:, 0], w.sa,
                               c.num_heads)
        outs = [fns.cross_attention(h, conds[key], qms[j], cm, sc[:, 1 + j],
                                    sh[:, 1 + j], w.cas[j], c.ca_heads)
                for j, key in enumerate(COND_KEYS)]
        h = Fn.linear(torch.cat(outs, dim=-1), w.wmix, w.bmix)
        h = fused_ffn_reference(h, sc[:, 4], sh[:, 4], w.ffn)
    return den.out(h)


# --------------------------------------------------------------- training

def stack_ca_params(den: GestureDenoiser, key: str) -> tuple:
    """One condition stream's cross-attention ``text_norm``/``key``/
    ``value`` parameters stacked over layers, as ``cond_contexts`` takes
    them: (ln_g, ln_b, wk, bk, wv, bv) with leading (L,) axes, the
    weights in the (in, out) layout.  ``torch.stack`` of the live
    parameters: gradients reach every layer's Linear and LayerNorm."""
    cas = [getattr(den.block(i), f"ca_{key}") for i in range(den.cfg.num_layers)]
    return (torch.stack([ca.text_norm.weight for ca in cas]),
            torch.stack([ca.text_norm.bias for ca in cas]),
            torch.stack([ca.key.weight.t() for ca in cas]),
            torch.stack([ca.key.bias for ca in cas]),
            torch.stack([ca.value.weight.t() for ca in cas]),
            torch.stack([ca.value.bias for ca in cas]))


def cross_attention_grouped_ctx(ca, x: torch.Tensor, ctx: torch.Tensor,
                                emb: torch.Tensor, query_mask,
                                num_heads: int) -> torch.Tensor:
    """One EfficientCrossAttention block applied with a precomputed
    per-head context ``ctx`` (B, H, Dh, Dh): the query side, the
    query-mask quirk, the stylization and the residual."""
    B, T, D = x.shape
    q = feature_softmax_q(ca.query(ca.norm(x)).reshape(B, T, num_heads, -1))
    y = apply_context(q, ctx)
    if query_mask is not None:
        y = y + (1.0 - query_mask).reshape(B, T, 1, 1) * NEG_MASK
    return x + ca.proj_out(y.reshape(B, T, D), emb)


def train_denoise_ctx(den: GestureDenoiser, latents: torch.Tensor,
                      t_orig: torch.Tensor, motion_mask: torch.Tensor,
                      conds: Dict[str, torch.Tensor], query_masks,
                      cond_mask, ctx_fn: Callable = cond_contexts
                      ) -> torch.Tensor:
    """The training forward of the denoiser (differentiable): latents
    (B, T, D), per-sample timesteps (B,), token mask (B, T) -> x0
    prediction (B, T, D).  Every layer's cross-attention context of each
    condition stream comes from one ``ctx_fn`` call per stream (kernel K3
    on the card; ``ctx_fn`` is its wrapper, or the plain version for a
    comparison); the rest is the eager layers' own forward."""
    c = den.cfg
    B = latents.shape[0]
    src_mask = motion_mask[..., None].to(latents.dtype)
    emb = den.time_embedding(t_orig)
    h = den.embed_tokens(latents)
    cm = None if cond_mask is None else cond_mask.reshape(B, 1, 1)
    ctx = {key: ctx_fn(conds[key], cm, *stack_ca_params(den, key),
                       num_heads=c.ca_heads)
           for key in COND_KEYS}
    for i in range(c.num_layers):
        blk = den.block(i)
        h = blk.sa_block(h, src_mask, emb)
        outs = [cross_attention_grouped_ctx(
                    getattr(blk, f"ca_{key}"), h, ctx[key][:, i], emb,
                    None if query_masks is None else query_masks[key],
                    c.ca_heads)
                for key in COND_KEYS]
        h = blk.ffn(blk.ca_mix(torch.cat(outs, dim=-1)), emb)
    return den.out(h)
