"""Cross linear attention at sampling time: against cached condition
contexts, kernels K4 (one block) and K7 (a layer's three blocks and
ca_mix), or uncached, kernel K6 (one block that computes its keys and
values from the condition rows in every call).

``fused_cross_attention_cached``, ``fused_cross_attention`` and
``fused_cross_block_cached`` replace the TPU kernels of the same names in
``raggesture_tpu/ops/pallas/linear_attention_kernel.py``.  On CUDA tensors
they launch the kernels of ``csrc/split_layer.cu``; on CPU tensors they run
their plain PyTorch versions (``*_reference``), which are also what the
kernels are held against on the card.  float32 throughout.  Where the JAX
functions take parameter subtrees, these take weight packs of the port's
modules (``pack_cross_attention``, ``pack_cross_attention_kv``,
``pack_cross_block``).

The contexts come per head, (B, H, Dh, Dh) and (B, 3, H, Dh, Dh), as the
layer kernel's (``decoder_layer.py``): the TPU kernels' dense
block-diagonal (D, D) contexts were a Mosaic layout whose off-diagonal
blocks are zero.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as Fn

from . import build
from . import split_layer as S
from .linear_attention import NEG_MASK, linear_attention_context


def _cross_shapes(D: int) -> list:
    return [(D,), (D,), (D, D), (D,)] + S.stylization_shapes(D)


class CrossAttentionWeights(S.Weights):
    """An EfficientCrossAttention's query-side tensors in the kernel's
    order: norm, query, then the stylization's styl-norm and out_proj (the
    key/value side lives in the cached context)."""

    names = ("ln_g", "ln_b", "wq", "bq", "sn_g", "sn_b", "wo", "bo")

    def shapes(self, D):
        return _cross_shapes(D)


class CrossAttentionKVWeights(CrossAttentionWeights):
    """An EfficientCrossAttention's tensors for the uncached kernel: the
    query side's (``CrossAttentionWeights``, in its order), then the key
    side's text_norm, key and value."""

    names = CrossAttentionWeights.names + ("tn_g", "tn_b", "wk", "bk",
                                           "wv", "bv")

    def shapes(self, D):
        return _cross_shapes(D) + [(D,), (D,), (D, D), (D,), (D, D), (D,)]


class CrossBlockWeights(S.Weights):
    """A DecoderLayer's three cross-attention packs (``cas``, text, audio,
    speaker) and ca_mix (``wmix`` (D, 3D), ``bmix``), flattened in the
    kernel's order."""

    names = tuple(f"{n}_{i}" for i in range(3)
                  for n in CrossAttentionWeights.names) + ("wmix", "bmix")

    def __init__(self, cas, wmix: torch.Tensor, bmix: torch.Tensor):
        super().__init__(*[t for ca in cas for t in ca.tensors], wmix, bmix)
        self.cas = tuple(cas)

    def shapes(self, D):
        return _cross_shapes(D) * 3 + [(D, 3 * D), (D,)]


def pack_cross_attention(block) -> CrossAttentionWeights:
    """The weight pack of a ``models.denoiser.EfficientCrossAttention``."""
    return CrossAttentionWeights(*S.norm_params(block.norm),
                                 *S.linear_params(block.query),
                                 *S.stylization_params(block.proj_out))


def pack_cross_attention_kv(block) -> CrossAttentionKVWeights:
    """The uncached kernel's weight pack of a
    ``models.denoiser.EfficientCrossAttention``."""
    return CrossAttentionKVWeights(*pack_cross_attention(block).tensors,
                                   *S.norm_params(block.text_norm),
                                   *S.linear_params(block.key),
                                   *S.linear_params(block.value))


def pack_cross_block(blocks: Sequence, mix: torch.nn.Linear
                     ) -> CrossBlockWeights:
    """The weight pack of a DecoderLayer's three cross attentions and its
    ca_mix Linear."""
    return CrossBlockWeights([pack_cross_attention(b) for b in blocks],
                             *S.linear_params(mix))


def query_tile_cols(Dh: int) -> int:
    """Columns of a block of the query side's first launch: whole heads,
    at least 32."""
    return max(32, Dh)


def query_workspace_floats(rows: int, D: int, heads: int, nz: int = 1
                           ) -> int:
    """Floats of the query side's workspace for ``rows`` rows and ``nz``
    conditions: y (rows, nz·D), then a (mean, M2) pair per condition, row
    and first-launch column tile, rounded up to whole float4s (what
    ``csrc/split_layer.cu::query_ws_floats`` lays out)."""
    tiles = D // query_tile_cols(D // heads)
    floats = nz * rows * D + 2 * nz * rows * tiles
    return -(-floats // 4) * 4


@torch.no_grad()
def fused_cross_attention_cached_reference(
    x: torch.Tensor,            # (B, T, D)
    ctx: torch.Tensor,          # (B, H, Dh, Dh) per-head cached context
    query_mask: torch.Tensor,   # (B, T, 1) output-side query mask
    scale: torch.Tensor,        # (B, D) adaLN scale of each sequence
    shift: torch.Tensor,        # (B, D)
    w: CrossAttentionWeights,
    num_heads: int,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_cross_attention_cached`."""
    xn = S.layer_norm(x, w.ln_g, w.ln_b)
    y = S.cached_cross_readout(w, xn, ctx, query_mask, num_heads)
    return x + S.stylize(y, w, scale, shift)


def fused_cross_attention_cached(
    x: torch.Tensor,
    ctx: torch.Tensor,
    query_mask: torch.Tensor,
    scale: torch.Tensor,
    shift: torch.Tensor,
    w: CrossAttentionWeights,
    num_heads: int,
) -> torch.Tensor:
    """One cached-context cross attention + stylization + residual.

    CPU tensors take :func:`fused_cross_attention_cached_reference`.  CUDA
    tensors launch the kernels (``fused_cross_attention_cached.launches``
    counts calls that did): x contiguous, ``ctx`` with contiguous batch
    elements (a view ``ctx3[:, i]`` qualifies), ``query_mask`` with evenly
    spaced rows (``qm3[..., i:i + 1]`` qualifies), ``scale``/``shift`` as
    for ``fused_self_attention``, the pack's tensors float32 and contiguous
    on the same card; anything else raises."""
    if x.device.type == "cpu":
        return fused_cross_attention_cached_reference(
            x, ctx, query_mask, scale, shift, w, num_heads)
    S.expect_shape("x", x, 3)
    B, T, D = x.shape
    S.expect_widths(D, num_heads, T, self_attention=False)
    Dh = D // num_heads
    S.expect_input("x", x, (B, T, D))
    ctx_b = S.expect_batched("ctx", ctx, (B, num_heads, Dh, Dh))
    qm_ld = S.expect_rows("query_mask", query_mask, (B, T, 1))
    scale_b = S.expect_batched("scale", scale, (B, D))
    shift_b = S.expect_batched("shift", shift, (B, D))
    ptrs = w.device_pointers(x, D)
    lib = S.library()
    out = torch.empty_like(x)
    ws = S.workspace(x, query_workspace_floats(B * T, D, num_heads))
    S.check(lib.rg_cross_attention_cached(
        x.data_ptr(), ctx.data_ptr(), ctx_b, query_mask.data_ptr(), qm_ld,
        scale.data_ptr(), scale_b, shift.data_ptr(), shift_b,
        ptrs, out.data_ptr(), ws.data_ptr(), B, T, D, num_heads,
        S.stream(x)))
    fused_cross_attention_cached.launches += 1
    return out


fused_cross_attention_cached.launches = 0


@torch.no_grad()
def fused_cross_attention_reference(
    x: torch.Tensor,            # (B, T, D)
    xf: torch.Tensor,           # (B, N, D) condition rows (pre-projected)
    query_mask: torch.Tensor,   # (B, T, 1) output-side query mask
    cond_mask: torch.Tensor,    # (B, 1, 1) condition dropout, {0, 1}
    scale: torch.Tensor,        # (B, D) adaLN scale of each sequence
    shift: torch.Tensor,        # (B, D)
    w: CrossAttentionKVWeights,
    num_heads: int,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_cross_attention`: the keys
    and values from the text_norm'd condition rows (the dropout mask added
    to k at -1e6 and multiplied into v's input, so the value bias survives
    it, as in the reference), each sequence's time softmax of k over its N
    rows, the per-head context, then the cached kernel's query side."""
    xn = S.layer_norm(x, w.ln_g, w.ln_b)
    xfn = S.layer_norm(xf, w.tn_g, w.tn_b)
    k = Fn.linear(xfn, w.wk, w.bk) + (1.0 - cond_mask) * NEG_MASK
    v = Fn.linear(xfn * cond_mask, w.wv, w.bv)
    ctx = linear_attention_context(torch.softmax(k, dim=1), v, num_heads)
    y = S.cached_cross_readout(w, xn, ctx, query_mask, num_heads)
    return x + S.stylize(y, w, scale, shift)


def kv_row_tile(N: int, Dh: int) -> int:
    """Condition rows per block of K6's key/value kernel: a block computes
    a tile's k and v columns of one head, 2·Dh wide, each thread 8 rows of
    4 columns (2048 / Dh rows: 64 at Dh 32), or one row where one such tile
    of 256 / Dh rows holds the whole stream (the speaker's one row)."""
    return 256 // Dh if N <= 256 // Dh else 2048 // Dh


def fused_cross_attention(
    x: torch.Tensor,
    xf: torch.Tensor,
    query_mask: torch.Tensor,
    cond_mask: torch.Tensor,
    scale: torch.Tensor,
    shift: torch.Tensor,
    w: CrossAttentionKVWeights,
    num_heads: int,
) -> torch.Tensor:
    """One uncached cross attention + stylization + residual: the keys and
    values of the N condition rows ``xf`` are computed in the call.

    CPU tensors take :func:`fused_cross_attention_reference`.  CUDA
    tensors launch the kernels (``fused_cross_attention.launches`` counts
    calls that did): x and ``xf`` contiguous, ``cond_mask`` a contiguous
    (B, 1, 1) tensor, ``query_mask``, ``scale`` and ``shift`` as for
    :func:`fused_cross_attention_cached`, the pack's tensors float32 and
    contiguous on the same card; anything else raises.  The workspace
    grows with B·N (the exemplars of an inversion)."""
    if x.device.type == "cpu":
        return fused_cross_attention_reference(
            x, xf, query_mask, cond_mask, scale, shift, w, num_heads)
    S.expect_shape("x", x, 3)
    S.expect_shape("xf", xf, 3)
    B, T, D = x.shape
    N = xf.shape[1]
    if N < 1:
        raise ValueError("xf: the kernel takes at least one condition row")
    S.expect_widths(D, num_heads, T, self_attention=False)
    Dh = D // num_heads
    if Dh > 64:
        raise ValueError(f"head width {Dh}: the key/value kernel takes 8, "
                         f"16, 32 or 64")
    S.expect_input("x", x, (B, T, D))
    S.expect_input("xf", xf, (B, N, D))
    build.expect("cond_mask", cond_mask, torch.float32, (B, 1, 1))
    qm_ld = S.expect_rows("query_mask", query_mask, (B, T, 1))
    scale_b = S.expect_batched("scale", scale, (B, D))
    shift_b = S.expect_batched("shift", shift, (B, D))
    for name, t in (("xf", xf), ("cond_mask", cond_mask)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    ptrs = w.device_pointers(x, D)
    lib = S.library()
    out = torch.empty_like(x)
    rows = kv_row_tile(N, Dh)
    tiles = -(-N // rows)
    ws = S.workspace(x, query_workspace_floats(B * T, D, num_heads)
                     + B * N * D + B * D * Dh
                     + B * num_heads * tiles * (2 * Dh + Dh * Dh))
    S.check(lib.rg_cross_attention(
        x.data_ptr(), xf.data_ptr(), N, rows, cond_mask.data_ptr(),
        query_mask.data_ptr(), qm_ld, scale.data_ptr(), scale_b,
        shift.data_ptr(), shift_b, ptrs, out.data_ptr(), ws.data_ptr(),
        B, T, D, num_heads, S.stream(x)))
    fused_cross_attention.launches += 1
    return out


fused_cross_attention.launches = 0


@torch.no_grad()
def fused_cross_block_cached_reference(
    x: torch.Tensor,             # (B, T, D)
    ctx3: torch.Tensor,          # (B, 3, H, Dh, Dh) text/audio/speaker
    query_mask3: torch.Tensor,   # (B, T, 3)
    scale3: torch.Tensor,        # (B, 3, D) adaLN scales, one per block
    shift3: torch.Tensor,        # (B, 3, D)
    w: CrossBlockWeights,
    num_heads: int,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_cross_block_cached`: one
    LayerNorm centering shared by the three blocks, each block's output
    o_i = x + stylize_i(...) and ca_mix as sum_i o_i W_mix[:, iD:(i+1)D]^T."""
    D = x.shape[-1]
    xc = S.layer_norm(x, 1.0, 0.0)
    acc = None
    for i, ca in enumerate(w.cas):
        xn = xc * ca.ln_g + ca.ln_b
        y = S.cached_cross_readout(ca, xn, ctx3[:, i],
                                   query_mask3[..., i:i + 1], num_heads)
        o = x + S.stylize(y, ca, scale3[:, i], shift3[:, i])
        term = Fn.linear(o, w.wmix[:, i * D:(i + 1) * D])
        acc = term if acc is None else acc + term
    return acc + w.bmix


def fused_cross_block_cached(
    x: torch.Tensor,
    ctx3: torch.Tensor,
    query_mask3: torch.Tensor,
    scale3: torch.Tensor,
    shift3: torch.Tensor,
    w: CrossBlockWeights,
    num_heads: int,
) -> torch.Tensor:
    """A DecoderLayer's three cached-context cross attentions and ca_mix.

    CPU tensors take :func:`fused_cross_block_cached_reference`.  CUDA
    tensors launch the kernels (``fused_cross_block_cached.launches``
    counts calls that did): x and ``query_mask3`` contiguous, ``ctx3`` and
    ``scale3``/``shift3`` with contiguous batch elements (a batch stride of
    0 shares one set of rows), the pack's tensors float32 and contiguous on
    the same card; anything else raises."""
    if x.device.type == "cpu":
        return fused_cross_block_cached_reference(
            x, ctx3, query_mask3, scale3, shift3, w, num_heads)
    S.expect_shape("x", x, 3)
    B, T, D = x.shape
    S.expect_widths(D, num_heads, T, self_attention=False)
    Dh = D // num_heads
    S.expect_input("x", x, (B, T, D))
    ctx_b = S.expect_batched("ctx3", ctx3, (B, 3, num_heads, Dh, Dh))
    S.expect_input("query_mask3", query_mask3, (B, T, 3))
    scale_b = S.expect_batched("scale3", scale3, (B, 3, D))
    shift_b = S.expect_batched("shift3", shift3, (B, 3, D))
    ptrs = w.device_pointers(x, D)
    lib = S.library()
    out = torch.empty_like(x)
    ws = S.workspace(x, 3 * B * T * D
                     + query_workspace_floats(B * T, D, num_heads, nz=3))
    S.check(lib.rg_cross_block_cached(
        x.data_ptr(), ctx3.data_ptr(), ctx_b, query_mask3.data_ptr(),
        scale3.data_ptr(), scale_b, shift3.data_ptr(), shift_b,
        ptrs, out.data_ptr(), ws.data_ptr(), B, T, D, num_heads,
        S.stream(x)))
    fused_cross_block_cached.launches += 1
    return out


fused_cross_block_cached.launches = 0
