"""One whole denoiser DecoderLayer per call at sampling time: kernel K1.

``fused_decoder_layer`` replaces the TPU kernel
``raggesture_tpu/ops/pallas/linear_attention_kernel.py::fused_decoder_layer``
and ``pack_decoder_layer`` its operand layout.  On CUDA tensors it launches
the hand-written kernel of ``csrc/decoder_layer.cu``, one cooperative launch
per call (its header note says what bounds it and how it is laid out); on
CPU tensors it runs ``fused_decoder_layer_reference``, the plain PyTorch
version of the same function, which is also what the kernel is held against
on the card.

Rows are the B sequences of Tp tokens merged, (B·Tp, D).  The cached
cross-attention contexts come per head, (B, 3, H, Dh, Dh): the TPU kernel's
dense block-diagonal (B, 3, D, D) contexts were a Mosaic layout whose
off-diagonal blocks are zero.  Products round their activation operand to
the pack's dtype and accumulate in float32, as the TPU kernel's ``mm`` did;
every LayerNorm and softmax is float32.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import build
from .linear_attention import NEG_MASK

LN_EPS = 1e-5


def _kernel_of(linear: torch.nn.Linear) -> torch.Tensor:
    """A Linear's weight in the JAX Dense (in, out) layout."""
    return linear.weight.detach().t()


@torch.no_grad()
def pack_decoder_layer(layer: torch.nn.Module,
                       dtype: torch.dtype = torch.bfloat16
                       ) -> Dict[str, torch.Tensor]:
    """Pack one ``models.denoiser.DecoderLayer``'s parameters.

    Layout (as the TPU kernel's pack):
      vecs (31, D) f32 — 0-7 sa: ln_s, ln_b, bq, bk, bv, styl_ln_s,
        styl_ln_b, bo; 8-25 per CA i (6 each): ln_s, ln_b, bq, styl_ln_s,
        styl_ln_b, bo; 26 ca_mix bias; 27-30 ffn: b2, styl_ln_s, styl_ln_b, bo
      b1 (F,) f32 — ffn linear1 bias
      mats (14, D, D) ``dtype`` — 0-3 sa wq/wk/wv/wo, 4-9 CA (wq, wo) x3,
        10-12 ca_mix thirds, 13 ffn stylization out
      w1 (D, F), w2 (F, D) ``dtype``
      tiles (14 D² + 2 D F,) bf16 — the same weights in the CUDA kernel's
        layout (``kernel_tiles``), only in a bf16 pack of widths the kernel
        takes (``kernel_widths``)
      gmma_tiles (14 D² + 2 D F,) bf16 — the same weights again in the
        row-tile design's layout (``gmma_tiles``), only in a bf16 pack of
        widths that design takes (``row_tile_widths``)
    """
    sa = layer.sa_block
    cas = [layer.ca_xf_text, layer.ca_xf_audio, layer.ca_xf_spk]
    ffn = layer.ffn
    D = sa.query.weight.shape[0]

    def styl(block):
        po = block.proj_out
        return [po.norm.weight, po.norm.bias, po.out_proj.bias], po.out_proj

    sa_styl, sa_wo = styl(sa)
    vec_list = [sa.norm.weight, sa.norm.bias, sa.query.bias, sa.key.bias,
                sa.value.bias] + sa_styl
    mat_list = [_kernel_of(sa.query), _kernel_of(sa.key),
                _kernel_of(sa.value), _kernel_of(sa_wo)]
    for ca in cas:
        ca_styl, ca_wo = styl(ca)
        vec_list += [ca.norm.weight, ca.norm.bias, ca.query.bias] + ca_styl
        mat_list += [_kernel_of(ca.query), _kernel_of(ca_wo)]
    vec_list.append(layer.ca_mix.bias)
    wmix = _kernel_of(layer.ca_mix)
    mat_list += [wmix[i * D:(i + 1) * D] for i in range(3)]
    ffn_styl, ffn_wo = styl(ffn)
    vec_list += [ffn.linear2.bias] + ffn_styl
    mat_list.append(_kernel_of(ffn_wo))
    packed = {
        "vecs": torch.stack([v.detach().float() for v in vec_list]),
        "b1": ffn.linear1.bias.detach().float().clone(),
        "mats": torch.stack([m.to(dtype) for m in mat_list]).contiguous(),
        "w1": _kernel_of(ffn.linear1).to(dtype).contiguous(),
        "w2": _kernel_of(ffn.linear2).to(dtype).contiguous(),
    }
    if dtype == torch.bfloat16 and kernel_widths(D, packed["w1"].shape[1]):
        packed["tiles"] = kernel_tiles(packed["mats"], packed["w1"],
                                       packed["w2"])
    if dtype == torch.bfloat16 and row_tile_widths(D, packed["w1"].shape[1]):
        packed["gmma_tiles"] = gmma_tiles(packed["mats"], packed["w1"],
                                          packed["w2"])
    return packed


def kernel_widths(D: int, F: int) -> bool:
    """Whether the CUDA kernel takes model width D and FFN width F: rows
    of D <= 512 held by a warp, A chunks of 64 or 128 columns."""
    return D <= 512 and D % 64 == 0 and F % 64 == 0


# The fewest sequences a call must carry for the kernel's row-tile design
# (several sequences' rows in one wgmma tile, each weight tile fetched once
# a row tile); below it the per-sequence design serves the call.  From the
# sweep in csrc/decoder_layer.cu's note (``bench_torch_k1.py --sweep``, an
# H100): the row-tile design is 9 % faster at 6 sequences, 3 % slower at
# 8 and faster from 10 on; 6 loses least at any count.
ROW_TILE_MIN_SEQUENCES = 6


def row_tile_widths(D: int, F: int) -> bool:
    """Whether the row-tile design takes model width D and FFN width F:
    the per-sequence design's widths, at least 256 wide (a narrower layer
    has too few column tiles to fill the card), D and F multiples of 128
    (a normalised row's 128-column runs, W1's 128-column tiles)."""
    return kernel_widths(D, F) and D >= 256 and D % 128 == 0 and F % 128 == 0


def uses_row_tiles(batch: int, Tp: int, D: int, F: int) -> bool:
    """Whether a call of ``batch`` sequences of Tp padded tokens runs the
    kernel's row-tile design: from ``ROW_TILE_MIN_SEQUENCES`` sequences
    on, sequences of at least 16 padded tokens (at most 12 in a row tile
    of 192 rows) and widths the design takes."""
    return (batch >= ROW_TILE_MIN_SEQUENCES and Tp >= 16
            and row_tile_widths(D, F))


def _swizzled_tiles(w: torch.Tensor, nt: int) -> torch.Tensor:
    """(K, N) -> (N / nt, K, nt) column tiles, each row's 16-byte chunks
    permuted as the kernel's ldmatrix reads them: chunk c of row k is
    stored at c ^ ((k >> 2) & 1) for 16-column tiles, at c ^ ((k >> 1) & 3)
    for wider ones, so that the eight rows one ldmatrix reads fall in
    distinct shared-memory banks."""
    K, N = w.shape
    C = nt // 8
    t = w.reshape(K, N // nt, C, 8).permute(1, 0, 2, 3)
    k = torch.arange(K, device=w.device)
    f = (k >> 2) & 1 if nt == 16 else (k >> 1) & 3
    src = torch.arange(C, device=w.device)[None, :] ^ f[:, None]
    return t[:, k[:, None], src]


def kernel_tiles(mats: torch.Tensor, w1: torch.Tensor,
                 w2: torch.Tensor) -> torch.Tensor:
    """The layer's weights as the CUDA kernel streams them: each unit's
    column tile contiguous, stage after stage (see ``csrc/decoder_layer.cu``):
    q | k | v of each 32-column head (96 columns), the self-attention out
    projection in 32-column tiles, each cross attention's query and out
    projections in 32-column tiles, ca_mix (3D, D) in 16-column tiles, W1 in
    32-, W2 in 16- and the FFN's out projection in 32-column tiles."""
    D = mats.shape[-1]
    qkv = torch.stack([mats[0], mats[1], mats[2]], dim=1)   # (D, 3, D)
    qkv = qkv.reshape(D, 3, D // 32, 32).permute(0, 2, 1, 3)
    parts = [_swizzled_tiles(qkv.reshape(D, 3 * D), 96),
             _swizzled_tiles(mats[3], 32)]
    parts += [_swizzled_tiles(mats[4 + 2 * i], 32) for i in range(3)]
    parts += [_swizzled_tiles(mats[5 + 2 * i], 32) for i in range(3)]
    parts += [_swizzled_tiles(mats[10:13].reshape(3 * D, D), 16),
              _swizzled_tiles(w1, 32), _swizzled_tiles(w2, 16),
              _swizzled_tiles(mats[13], 32)]
    return torch.cat([t.reshape(-1) for t in parts])


def _gmma_stage(w: torch.Tensor, nt: int) -> torch.Tensor:
    """(K, N) -> (N / nt, K / 64, nt, 64): column tiles, each its K in
    chunks of 64, a chunk the tile's nt columns as rows of 64 contraction
    elements (wgmma's K-major operand), the 16-byte chunk c of row n stored
    at c ^ (n & 7) (the 128-byte swizzle)."""
    K, N = w.shape
    t = w.reshape(K // 64, 64, N // nt, nt).permute(2, 0, 3, 1)
    t = t.reshape(N // nt, K // 64, nt, 8, 8)
    n = torch.arange(nt, device=w.device)
    src = torch.arange(8, device=w.device)[None, :] ^ (n[:, None] & 7)
    return t[:, :, n[:, None], src]


def gmma_tiles(mats: torch.Tensor, w1: torch.Tensor,
               w2: torch.Tensor) -> torch.Tensor:
    """The layer's weights as the kernel's row-tile design streams them
    (see ``csrc/decoder_layer.cu``): stage after stage as in
    ``kernel_tiles``, each unit's column tile contiguous, its K in chunks
    of 64 in wgmma's swizzled K-major layout: q | k | v of each 32-column
    head (96 columns), 128-column tiles of W1, 64-column tiles of every
    other matrix (the cross attentions' queries two heads a tile)."""
    D = mats.shape[-1]
    qkv = torch.stack([mats[0], mats[1], mats[2]], dim=1)   # (D, 3, D)
    qkv = qkv.reshape(D, 3, D // 32, 32).permute(0, 2, 1, 3)
    parts = [_gmma_stage(qkv.reshape(D, 3 * D), 96),
             _gmma_stage(mats[3], 64)]
    parts += [_gmma_stage(mats[4 + 2 * i], 64) for i in range(3)]
    parts += [_gmma_stage(mats[5 + 2 * i], 64) for i in range(3)]
    parts += [_gmma_stage(mats[10:13].reshape(3 * D, D), 64),
              _gmma_stage(w1, 128), _gmma_stage(w2, 64),
              _gmma_stage(mats[13], 64)]
    return torch.cat([t.reshape(-1) for t in parts])


def fused_decoder_layer_reference(
    x: torch.Tensor,            # (B*Tp, D) float32 rows
    src_mask: torch.Tensor,     # (B*Tp, 1) token validity
    query_mask3: torch.Tensor,  # (B*Tp, 3) cross-attention query masks
    scale5: torch.Tensor,       # (5, D) adaLN scales (sa, 3 CAs, ffn)
    shift5: torch.Tensor,       # (5, D) adaLN shifts
    ctx3: torch.Tensor,         # (B, 3, Hc, Dh, Dh) per-head contexts
    packed: Dict[str, torch.Tensor],
    num_heads: int,
    ca_heads: int,
    batch: int,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_decoder_layer`."""
    R, D = x.shape
    Tp = R // batch
    cd = packed["mats"].dtype
    vecs, mats = packed["vecs"], packed["mats"]
    w1, w2, b1 = packed["w1"], packed["w2"], packed["b1"]
    m = src_mask.reshape(R, 1).float()
    qm = query_mask3.reshape(R, 3).float()

    def rnd(a):
        return a.to(cd).float()

    def mm(a, w):
        return rnd(a) @ w.float()

    def center(v):
        mu = v.mean(-1, keepdim=True)
        var = ((v - mu) ** 2).mean(-1, keepdim=True)
        return (v - mu) * torch.rsqrt(var + LN_EPS)

    def stylize(y, j, wo, k):
        # styl-norm affine and adaLN affine combined, as the TPU kernel does
        es = vecs[j] * (1.0 + scale5[k])
        eb = vecs[j + 1] * (1.0 + scale5[k]) + shift5[k]
        h = center(y) * es + eb
        h = h * torch.sigmoid(h)
        return mm(h, wo) + vecs[j + 2]

    def feature_softmax(q, heads):
        qh = q.reshape(R, heads, D // heads)
        qe = torch.exp(qh - qh.amax(-1, keepdim=True))
        return (qe / qe.sum(-1, keepdim=True).clamp_min(1e-30)).reshape(R, D)

    def per_head(a, heads):
        return rnd(a).reshape(batch, Tp, heads, D // heads)

    # ---- self attention ----
    H = num_heads
    xn = center(x) * vecs[0] + vecs[1]
    q = mm(xn, mats[0]) + vecs[2]
    k = mm(xn, mats[1]) + vecs[3] + (1.0 - m) * NEG_MASK
    v = (mm(xn, mats[2]) + vecs[4]) * m
    q_sm = feature_softmax(q, H)
    # time softmax per sequence (never across the batch)
    k_sm = torch.softmax(k.reshape(batch, Tp, D), dim=1).reshape(R, D)
    ctx = torch.einsum("bthd,bthe->bhde", per_head(k_sm, H), per_head(v, H))
    y = torch.einsum("bthd,bhde->bthe", per_head(q_sm, H), rnd(ctx))
    h1 = x + stylize(y.reshape(R, D), 5, mats[3], 0)

    # ---- three cached-context cross attentions + ca_mix ----
    Hc = ca_heads
    hc = center(h1)
    acc = None
    for i in range(3):
        base = 8 + 6 * i
        q = mm(hc * vecs[base] + vecs[base + 1], mats[4 + 2 * i]) + vecs[base + 2]
        q_sm = feature_softmax(q, Hc)
        y = torch.einsum("bthd,bhde->bthe", per_head(q_sm, Hc),
                         ctx3[:, i].float()).reshape(R, D)
        y = y + (1.0 - qm[:, i:i + 1]) * NEG_MASK
        o_i = h1 + stylize(y, base + 3, mats[5 + 2 * i], 1 + i)
        term = mm(o_i, mats[10 + i])
        acc = term if acc is None else acc + term
    h2 = acc + vecs[26]

    # ---- FFN ----
    f = mm(h2, w1) + b1
    f = f * 0.5 * (1.0 + torch.erf(f * 0.7071067811865476))
    y = mm(f, w2) + vecs[27]
    return h2 + stylize(y, 28, mats[13], 4)


def _library() -> ctypes.CDLL:
    lib = build.load("decoder_layer")
    fn = lib.rg_decoder_layer
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    lib.rg_decoder_layer_trace_slots.restype = ctypes.c_int
    lib.rg_decoder_layer_workspace_bytes.restype = ctypes.c_long
    lib.rg_decoder_layer_workspace_bytes.argtypes = [ctypes.c_int] * 3
    lib.rg_decoder_layer_error_string.restype = ctypes.c_char_p
    lib.rg_decoder_layer_error_string.argtypes = [ctypes.c_int]
    return lib


# The kernel's grid-barrier word, one per device: zero when made; a call
# leaves its low bits as it found them.  Made at a device's first call, so
# that a CUDA graph captured after a warm-up call finds it.
_barriers: Dict[int, torch.Tensor] = {}


def _barrier(device: torch.device) -> torch.Tensor:
    bar = _barriers.get(device.index)
    if bar is None:
        bar = torch.zeros(1, dtype=torch.int32, device=device)
        _barriers[device.index] = bar
    return bar


def fused_decoder_layer(
    x: torch.Tensor,
    src_mask: torch.Tensor,
    query_mask3: torch.Tensor,
    scale5: torch.Tensor,
    shift5: torch.Tensor,
    ctx3: torch.Tensor,
    packed: Dict[str, torch.Tensor],
    num_heads: int,
    ca_heads: int,
    batch: int,
    *,
    trace: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One DecoderLayer over ``batch`` sequences merged into rows.

    CPU tensors take :func:`fused_decoder_layer_reference`.  CUDA tensors
    launch the kernel, one launch per call (``fused_decoder_layer.launches``
    counts them), and must be float32 apart from the bf16 ``mats``/``w1``/
    ``w2``/``tiles``/``gmma_tiles`` and ``ctx3``; anything else raises.
    The call's shapes pick the kernel's design (``uses_row_tiles``);
    ``fused_decoder_layer.row_tile_launches`` counts the calls that took
    the row-tile design.  Calls on one
    device must not run at the same time on two streams: they share the
    barrier word.  ``trace``, for a measurement: an int64 CUDA tensor of
    (SMs, ``trace_slots()``) that the kernel fills with %globaltimer marks
    (``csrc/decoder_layer.cu``, kTraceSlots)."""
    if x.device.type == "cpu":
        return fused_decoder_layer_reference(
            x, src_mask, query_mask3, scale5, shift5, ctx3, packed,
            num_heads, ca_heads, batch)
    R, D = x.shape
    F = packed["w1"].shape[-1]
    Tp = R // batch
    # the kernel's limits: heads of 32 columns (a head is one tile), a
    # sequence's rows in one product tile of 48, and its widths; any batch
    if (R % batch or Tp % 8 or Tp > 48 or not kernel_widths(D, F)
            or D != 32 * num_heads or D != 32 * ca_heads):
        raise ValueError(f"unsupported shape: rows {R}, batch {batch}, "
                         f"D {D}, F {F}, heads {num_heads}/{ca_heads}: the "
                         f"kernel takes head width 32, sequences of at most "
                         f"48 padded tokens (a multiple of 8), D <= 512 and "
                         f"D, F multiples of 64, at any batch")
    f32, bf16 = torch.float32, torch.bfloat16
    build.expect("x", x, f32, (R, D))
    build.expect("src_mask", src_mask, f32, (R, 1))
    build.expect("query_mask3", query_mask3, f32, (R, 3))
    build.expect("scale5", scale5, f32, (5, D))
    build.expect("shift5", shift5, f32, (5, D))
    build.expect("ctx3", ctx3, bf16, (batch, 3, ca_heads, 32, 32))
    build.expect("vecs", packed["vecs"], f32, (31, D))
    build.expect("b1", packed["b1"], f32, (F,))
    build.expect("mats", packed["mats"], bf16, (14, D, D))
    build.expect("w1", packed["w1"], bf16, (D, F))
    build.expect("w2", packed["w2"], bf16, (F, D))
    build.expect("tiles", packed.get("tiles", x), bf16,
                 (14 * D * D + 2 * D * F,))
    row_tiles = uses_row_tiles(batch, Tp, D, F)
    if row_tiles:
        build.expect("gmma_tiles", packed.get("gmma_tiles", x), bf16,
                     (14 * D * D + 2 * D * F,))
    lib = _library()
    if trace is not None:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        build.expect("trace", trace, torch.int64,
                     (sms, lib.rg_decoder_layer_trace_slots()))
    out = torch.empty_like(x)
    ws = torch.empty(-(-lib.rg_decoder_layer_workspace_bytes(R, D, F) // 4),
                     device=x.device, dtype=f32)
    status = lib.rg_decoder_layer(
        x.data_ptr(), src_mask.data_ptr(), query_mask3.data_ptr(),
        scale5.data_ptr(), shift5.data_ptr(), ctx3.data_ptr(),
        packed["vecs"].data_ptr(), packed["b1"].data_ptr(),
        packed["tiles"].data_ptr(),
        packed["gmma_tiles"].data_ptr() if row_tiles else 0,
        out.data_ptr(), ws.data_ptr(),
        _barrier(x.device).data_ptr(),
        0 if trace is None else trace.data_ptr(), batch, Tp, D, num_heads,
        ca_heads, F,
        torch.cuda.current_stream(x.device).cuda_stream)
    if status < 0:   # a shape past the kernel's limits on this card
        why = lib.rg_decoder_layer_error_string(status).decode()
        raise ValueError(f"unsupported shape: rows {R}, D {D}, F {F}: {why}")
    build.check(lib, "rg_decoder_layer", status)
    fused_decoder_layer.launches += 1
    fused_decoder_layer.row_tile_launches += row_tiles
    return out


fused_decoder_layer.launches = 0
fused_decoder_layer.row_tile_launches = 0


def trace_slots() -> int:
    """Trace slots per block of the kernel (``fused_decoder_layer``'s
    ``trace``)."""
    return _library().rg_decoder_layer_trace_slots()
