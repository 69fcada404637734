"""All-layer cross-attention contexts of one condition stream for the
training step, with gradients: kernel K3.

``cond_contexts`` replaces the TPU kernels of
``raggesture_tpu/ops/pallas/cond_ctx_kernel.py::cond_contexts`` (a forward
and two backward kernels behind a ``custom_vjp``).  For condition features
``xf`` (B, N, D), padded to Np rows (a multiple of 8) with row validity
``nv``, and the stacked per-layer parameters of the L cross-attentions'
``text_norm``/``key``/``value`` (``models/fused_denoiser.py::
stack_ca_params``), it computes per layer l

    xn  = centre(xf) * ln_g[l] + ln_b[l]          (LayerNorm, eps 1e-5)
    k   = (xn @ wk[l] + bk[l]) + (1 - cm)(-1e6) + (1 - nv)(-1e6)
    v   = ((xn * cm) @ wv[l] + bv[l]) * nv
    ctx = softmax_time(k)ᵀ v                        per head: (H, Dh, Dh)

and returns (B, L, H, Dh, Dh).  The TPU's (B, L, G, 128, 128) output,
block-diagonal inside 128-lane groups, was a Mosaic layout; per head is
the same function.  ``cm`` (B, 1, 1) is the condition-dropout mask and
gets no gradient, nor does ``nv``.

On CPU tensors the wrapper runs the plain versions below (the forward and
the analytic backward) through the same ``torch.autograd.Function``; on
CUDA tensors it launches the kernels of ``csrc/cond_ctx.cu`` (whose header
says what bounds them and how they are laid out) or raises: the forward
(three launches, two where every sequence lies whole in one row tile;
its plan is :func:`forward_records`), backward A (four launches, reading
the forward's LayerNorm rows) and backward B (two).  The
plain versions take an operand dtype: products round their operands to it
and accumulate in the compute dtype, as the kernels do in bf16; LayerNorm,
softmax and every sum stay in the compute dtype.  On the card the kernels
are held against the plain versions with bf16 operands; on the CPU the
plain versions run in float32 (or float64) and are held against JAX.

``xf`` may also be bf16 (the training step's ``bf16_compute``), with the
parameters in bf16: as the JAX ``custom_vjp``, LayerNorm's and the biases'
parameters are read as float32 and the contexts come back float32; the
gradients come back in each input's dtype.  On the card the wrappers
launch the kernels' bf16 entry points (bf16 rows in, bf16 dxf out, the
same launches); the plain versions upcast xf to float32, as the JAX
reference does off the TPU.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as Fn

from . import build
from .linear_attention import NEG_MASK

LN_EPS = 1e-5
_COLS = 128                     # columns of a kernel tile: whole heads
_DH_SUPPORTED = (8, 16, 32)


def _rnd(a: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``a`` rounded to an operand dtype and back (no-op for None)."""
    return a if dtype is None else a.to(dtype).to(a.dtype)


def _centre(xf: torch.Tensor):
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    r = torch.rsqrt(var + LN_EPS)
    return (xf - mu) * r, r


def _layer_kv(c, cm, nv, g, b, wk, bk, wv, bv, od):
    """xn, vin, v and the time softmax of k for one layer (the JAX
    kernels' ``_layer_kv``), from the centred input."""
    xn = c * g + b
    k = _rnd(xn, od) @ _rnd(wk, od) + bk
    k = k + (1.0 - cm) * NEG_MASK + (1.0 - nv) * NEG_MASK
    vin = xn * cm
    v = (_rnd(vin, od) @ _rnd(wv, od) + bv) * nv
    e = torch.exp(k - k.amax(dim=1, keepdim=True))
    return xn, vin, v, e / e.sum(dim=1, keepdim=True)


def _heads(a: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, N, D = a.shape
    return a.reshape(B, N, num_heads, D // num_heads)


def _dk_dv(ksm, v, dctx_l, num_heads):
    """dk and dv from one layer's context cotangent (B, H, Dh, Dh), the
    column-softmax vjp included."""
    B, N, D = ksm.shape
    dksm = torch.einsum("bnhe,bhde->bnhd", _heads(v, num_heads),
                        dctx_l).reshape(B, N, D)
    dv = torch.einsum("bnhd,bhde->bnhe", _heads(ksm, num_heads),
                      dctx_l).reshape(B, N, D)
    dk = ksm * (dksm - (dksm * ksm).sum(dim=1, keepdim=True))
    return dk, dv


def cond_ctx_reference(xf, cm, nv, ln_g, ln_b, wk, bk, wv, bv,
                       num_heads: int,
                       operand_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """Plain forward.  xf (B, Np, D) padded; cm (B, 1, 1); nv (B, Np, 1);
    ln_g, ln_b, bk, bv (L, D); wk, wv (L, D, D) in the (in, out) layout.
    Returns (B, L, H, Dh, Dh) in xf's dtype."""
    c, _ = _centre(xf)
    outs = []
    for l in range(wk.shape[0]):
        _, _, v, ksm = _layer_kv(c, cm, nv, ln_g[l], ln_b[l], wk[l], bk[l],
                                 wv[l], bv[l], operand_dtype)
        outs.append(torch.einsum("bnhd,bnhe->bhde", _heads(ksm, num_heads),
                                 _heads(v, num_heads)))
    return torch.stack(outs, dim=1)


def cond_ctx_bwd_a_reference(xf, cm, nv, ln_g, ln_b, wk, bk, wv, bv, dctx,
                             num_heads: int,
                             operand_dtype: Optional[torch.dtype] = None):
    """Plain version of backward A (the JAX ``_bwd_a_kernel``): dxf and the
    LayerNorm affine gradients (dg, db), each (L, D), summed over the
    batch."""
    od = operand_dtype
    c, r = _centre(xf)
    dc = torch.zeros_like(c)
    dgs, dbs = [], []
    for l in range(wk.shape[0]):
        _, _, v, ksm = _layer_kv(c, cm, nv, ln_g[l], ln_b[l], wk[l], bk[l],
                                 wv[l], bv[l], od)
        dk, dv = _dk_dv(ksm, v, dctx[:, l], num_heads)
        dv = dv * nv
        dxn = (_rnd(dk, od) @ _rnd(wk[l], od).t()
               + (_rnd(dv, od) @ _rnd(wv[l], od).t()) * cm)
        dgs.append((dxn * c).sum(dim=(0, 1)))
        dbs.append(dxn.sum(dim=(0, 1)))
        dc = dc + dxn * ln_g[l]
    # LayerNorm centring backward: y = (x - mu) * r
    dxf = r * (dc - dc.mean(-1, keepdim=True)
               - c * (dc * c).mean(-1, keepdim=True))
    return dxf, torch.stack(dgs), torch.stack(dbs)


def cond_ctx_bwd_b_reference(xf, cm, nv, ln_g, ln_b, wk, bk, wv, bv, dctx,
                             num_heads: int,
                             operand_dtype: Optional[torch.dtype] = None):
    """Plain version of backward B (the JAX ``_bwd_b_kernel``): dwk (L, D,
    D), dbk (L, D), dwv, dbv, summed over the batch."""
    od = operand_dtype
    c, _ = _centre(xf)
    D = xf.shape[-1]
    outs = []
    for l in range(wk.shape[0]):
        xn, vin, v, ksm = _layer_kv(c, cm, nv, ln_g[l], ln_b[l], wk[l],
                                    bk[l], wv[l], bv[l], od)
        dk, dv = _dk_dv(ksm, v, dctx[:, l], num_heads)
        dv = dv * nv
        outs.append((
            _rnd(xn, od).reshape(-1, D).t() @ _rnd(dk, od).reshape(-1, D),
            dk.sum(dim=(0, 1)),
            _rnd(vin, od).reshape(-1, D).t() @ _rnd(dv, od).reshape(-1, D),
            dv.sum(dim=(0, 1))))
    return tuple(torch.stack(t) for t in zip(*outs))


def cond_ctx_backward_reference(xf, cm, nv, ln_g, ln_b, wk, bk, wv, bv,
                                dctx, num_heads: int,
                                operand_dtype: Optional[torch.dtype] = None):
    """The plain analytic backward: (dxf, dg, db, dwk, dbk, dwv, dbv)."""
    args = (xf, cm, nv, ln_g, ln_b, wk, bk, wv, bv, dctx, num_heads,
            operand_dtype)
    return cond_ctx_bwd_a_reference(*args) + cond_ctx_bwd_b_reference(*args)


# ------------------------------------------------------------- the kernels

def _library() -> ctypes.CDLL:
    lib = build.load("cond_ctx")
    p, i = ctypes.c_void_p, ctypes.c_int
    sigs = {"rg_cond_ctx_forward": [p] * 16 + [i] * 6 + [p],
            "rg_cond_ctx_backward_a": [p] * 22 + [i] * 5 + [p],
            "rg_cond_ctx_backward_b": [p] * 8 + [i] * 5 + [p]}
    sigs["rg_cond_ctx_forward_bf16"] = sigs["rg_cond_ctx_forward"]
    sigs["rg_cond_ctx_backward_a_bf16"] = sigs["rg_cond_ctx_backward_a"]
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return lib


TILE_ROWS = 128    # flat rows of a kernel's row tile (kTileRows)
CHUNK_ROWS = 64    # rows of one stage of the weight-gradient product (kBox)
W_TILE = (128, 256)   # a weight-gradient block's rows i and columns j


def row_tiles(B: int, Np: int) -> int:
    """Row tiles over the R = B * Np flat rows (a tile may straddle
    sequences); in the backward each gives one partial of the bias and
    LayerNorm-affine sums."""
    return -(-B * Np // TILE_ROWS)


class ForwardPlan(NamedTuple):
    """Where the forward's row tiles cut the sequences.  Sequence b has the
    rows [b Np, (b + 1) Np) and spans the tiles ``first[b]`` ..
    ``last[b]``; it is ``whole`` when that is one tile, and then that
    tile's kernel writes its contexts.  Otherwise each tile writes a record
    (m_t, s_t, C_t) to slot b + t of the workspace of ``shape`` (no two
    (sequence, tile) pairs share b + t: a later sequence starts in the
    same tile or a later one) and the merge launch combines them in tile
    order; ``merge`` is False, and the workspace empty, when every
    sequence is whole."""
    first: Tuple[int, ...]
    last: Tuple[int, ...]
    whole: Tuple[bool, ...]
    slots: int
    shape: Tuple[int, ...]
    merge: bool


@functools.lru_cache(maxsize=64)
def forward_records(B: int, Np: int, D: int, L: int,
                    Dh: int) -> ForwardPlan:
    """The forward's plan at these shapes (see :class:`ForwardPlan`); a
    record holds 128 column maxima, 128 sums and the 128 x Dh unnormalised
    contexts of one (slot, layer, 128-column tile)."""
    first = tuple(b * Np // TILE_ROWS for b in range(B))
    last = tuple(((b + 1) * Np - 1) // TILE_ROWS for b in range(B))
    whole = tuple(f == t for f, t in zip(first, last))
    merge = not all(whole)
    slots = B + row_tiles(B, Np) - 1 if merge else 0
    return ForwardPlan(first, last, whole, slots,
                       (slots, L, D // _COLS, 2 * _COLS + _COLS * Dh), merge)


def forward_workspaces(B: int, Np: int, D: int, L: int, Dh: int):
    """{name: (shape, dtype)} of what the forward wrapper allocates besides
    its outputs: xn, the LayerNorm of every layer in bf16 (saved for the
    backward), and the records of the sequences that span row tiles."""
    return {"xn": ((L, B, Np, D), torch.bfloat16),
            "records": (forward_records(B, Np, D, L, Dh).shape,
                        torch.float32)}


def weight_splits(B: int, Np: int, D: int, L: int, sms: int) -> int:
    """Chunks the weight-gradient product cuts its contraction over the
    B * Np rows into (whole CHUNK_ROWS stages each): enough that its W_TILE
    blocks times the chunks fill the ``sms`` SMs once, one where the blocks
    alone do, never more than the stages."""
    stages = -(-B * Np // CHUNK_ROWS)
    blocks = (D // W_TILE[0]) * (2 * D // W_TILE[1]) * L
    return max(1, min(stages, sms // blocks))


def split_chunks(stages: int, splits: int):
    """The [first, last) stages of each chunk, in the kernel's order."""
    return [(s * stages // splits, (s + 1) * stages // splits)
            for s in range(splits)]


def backward_workspaces(B: int, Np: int, D: int, L: int, splits: int):
    """{name: (shape, dtype)} of what the backward wrappers allocate besides
    the gradients: dk and cm dv (backward A writes them, B reads them with
    the forward's xn), the per-tile partials and dc of backward A, and the
    float32 partial of each weight-gradient chunk ``ws``."""
    f32, bf16 = torch.float32, torch.bfloat16
    t = row_tiles(B, Np)
    return {"dk": ((L, B, Np, D), bf16),
            "dv": ((L, B, Np, D), bf16), "dbkv_part": ((t, 2, L, D), f32),
            "dgb_part": ((t, L, 2, D), f32), "dc": ((B, Np, D), f32),
            "ws": ((splits, L, D, 2 * D), f32)}


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_inputs(xf, cm, nv, ln_g, ln_b, wk, bk, wv, bv, num_heads):
    if xf.dim() != 3 or wk.dim() != 3:
        raise ValueError(f"xf (B, Np, D) and wk (L, D, D) expected, got "
                         f"{tuple(xf.shape)} and {tuple(wk.shape)}")
    B, Np, D = xf.shape
    L = wk.shape[0]
    if D % _COLS or D % num_heads or D // num_heads not in _DH_SUPPORTED:
        raise ValueError(f"width {D} with {num_heads} heads: the kernels take "
                         f"a multiple of {_COLS} and head widths "
                         f"{_DH_SUPPORTED}")
    if Np % 8:
        raise ValueError(f"{Np} rows: pad to a multiple of 8")
    f32, bf16 = torch.float32, torch.bfloat16
    build.expect("xf", xf, bf16 if xf.dtype == bf16 else f32, (B, Np, D))
    build.expect("cm", cm, f32, (B, 1, 1))
    build.expect("nv", nv, f32, (B, Np, 1))
    for name, t in (("ln_g", ln_g), ("ln_b", ln_b), ("bk", bk), ("bv", bv)):
        build.expect(name, t, f32, (L, D))
    build.expect("wk", wk, bf16, (L, D, D))
    build.expect("wv", wv, bf16, (L, D, D))
    return B, Np, D, L


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _entry(lib: ctypes.CDLL, name: str, xf: torch.Tensor):
    """The float32 entry point ``name`` or, for bf16 ``xf``, its bf16 one."""
    return getattr(lib, name + ("_bf16" if xf.dtype == torch.bfloat16
                                else ""))


def cond_ctx_forward(xf, cm, nv, ln_g, ln_b, wk, bk, wv, bv, num_heads: int):
    """Forward kernels on CUDA tensors (bf16 ``wk``/``wv``, ``xf`` float32
    or bf16, the rest float32, contiguous; anything else raises).  A bf16
    ``xf`` takes the bf16 entry point, with the same launches.  Returns the
    contexts (B, L, H, Dh, Dh) and what the backward kernels read: the row
    mean and rstd (B, Np), the column max and sum of the time softmax (B,
    L, D) and xn, the bf16 LayerNorm of every layer (L, B, Np, D).
    ``cond_ctx_forward.launches`` counts its calls."""
    B, Np, D, L = _check_inputs(xf, cm, nv, ln_g, ln_b, wk, bk, wv, bv,
                                num_heads)
    Dh = D // num_heads
    plan = forward_records(B, Np, D, L, Dh)
    lib = _library()
    opts = dict(device=xf.device, dtype=torch.float32)
    out = torch.empty(B, L, num_heads, Dh, Dh, **opts)
    mean = torch.empty(B, Np, **opts)
    rstd = torch.empty(B, Np, **opts)
    colmax = torch.empty(B, L, D, **opts)
    colsum = torch.empty(B, L, D, **opts)
    spec = forward_workspaces(B, Np, D, L, Dh)
    xn, rec = (torch.empty(*spec[n][0], device=xf.device, dtype=spec[n][1])
               for n in ("xn", "records"))
    status = _entry(lib, "rg_cond_ctx_forward", xf)(
        xf.data_ptr(), cm.data_ptr(), nv.data_ptr(), ln_g.data_ptr(),
        ln_b.data_ptr(), wk.data_ptr(), bk.data_ptr(), wv.data_ptr(),
        bv.data_ptr(), out.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        colmax.data_ptr(), colsum.data_ptr(), xn.data_ptr(), rec.data_ptr(),
        B, Np, D, L, num_heads, plan.slots, _stream(xf))
    build.check(lib, "rg_cond_ctx", status)
    cond_ctx_forward.launches += 1
    return out, (mean, rstd, colmax, colsum, xn)


def cond_ctx_backward_a(xf, cm, nv, ln_g, ln_b, wk, bk, wv, bv, out, saved,
                        dctx, num_heads: int):
    """Backward-A kernels on CUDA tensors: (dxf, dg, db) and the
    intermediates backward B reads: xn (the forward's, from ``saved``), dk
    and cm dv, each bf16 (L, B, Np, D), and per row tile the column sums of
    dk and dv (row tiles, 2, L, D).  ``cm`` must be 0 or 1 per sequence (a
    condition-dropout mask).  ``cond_ctx_backward_a.launches`` counts its
    calls.  dxf comes back in xf's dtype (bf16 from the bf16 entry)."""
    B, Np, D, L = _check_inputs(xf, cm, nv, ln_g, ln_b, wk, bk, wv, bv,
                                num_heads)
    Dh = D // num_heads
    mean, rstd, colmax, colsum, xn = saved
    build.expect("out", out, torch.float32, (B, L, num_heads, Dh, Dh))
    build.expect("dctx", dctx, torch.float32, (B, L, num_heads, Dh, Dh))
    for name, t, shape in (("mean", mean, (B, Np)), ("rstd", rstd, (B, Np)),
                           ("colmax", colmax, (B, L, D)),
                           ("colsum", colsum, (B, L, D))):
        build.expect(name, t, torch.float32, shape)
    build.expect("xn", xn, torch.bfloat16, (L, B, Np, D))
    lib = _library()
    dev = xf.device
    f32 = dict(device=dev, dtype=torch.float32)
    spec = backward_workspaces(B, Np, D, L, 1)
    dk, dv, dbkv_part, dgb_part, dc = (
        torch.empty(*spec[n][0], device=dev, dtype=spec[n][1])
        for n in ("dk", "dv", "dbkv_part", "dgb_part", "dc"))
    dxf = torch.empty(B, Np, D, device=dev, dtype=xf.dtype)
    dgb = torch.empty(L, 2, D, **f32)
    status = _entry(lib, "rg_cond_ctx_backward_a", xf)(
        xf.data_ptr(), cm.data_ptr(), nv.data_ptr(), ln_g.data_ptr(),
        wk.data_ptr(), bk.data_ptr(), wv.data_ptr(), bv.data_ptr(),
        out.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        colmax.data_ptr(), colsum.data_ptr(), dctx.data_ptr(),
        xn.data_ptr(), dk.data_ptr(), dv.data_ptr(), dbkv_part.data_ptr(),
        dgb_part.data_ptr(), dc.data_ptr(), dxf.data_ptr(), dgb.data_ptr(),
        B, Np, D, L, num_heads, _stream(xf))
    build.check(lib, "rg_cond_ctx", status)
    cond_ctx_backward_a.launches += 1
    return dxf, dgb[:, 0], dgb[:, 1], (xn, dk, dv, dbkv_part)


def cond_ctx_backward_b(xf, cm, ln_g, ln_b, saved, inter):
    """Backward-B kernels on CUDA tensors: (dwk, dbk, dwv, dbv), summed
    over the batch in a fixed order (no atomics: two runs are bitwise
    equal).  ``saved`` is the forward's, ``inter`` backward A's (the
    forward has already normalised the rows: ``xf``, ``ln_g``, ``ln_b`` and
    ``saved`` are checked, not read).  ``cond_ctx_backward_b.launches`` counts its
    calls."""
    xn, dk, dv, dbkv_part = inter
    L, B, Np, D = dk.shape
    f32 = torch.float32
    build.expect("xf", xf, torch.bfloat16 if xf.dtype == torch.bfloat16
                 else f32, (B, Np, D))
    build.expect("cm", cm, f32, (B, 1, 1))
    build.expect("ln_g", ln_g, f32, (L, D))
    build.expect("ln_b", ln_b, f32, (L, D))
    build.expect("mean", saved[0], f32, (B, Np))
    build.expect("rstd", saved[1], f32, (B, Np))
    if D % _COLS:
        raise ValueError(f"width {D}: the weight-gradient kernel takes a "
                         f"multiple of {_COLS}")
    splits = weight_splits(B, Np, D, L, _sms(xf.device))
    spec = backward_workspaces(B, Np, D, L, splits)
    build.expect("xn", xn, torch.bfloat16, (L, B, Np, D))
    for name, t in (("dk", dk), ("dv", dv), ("dbkv_part", dbkv_part)):
        build.expect(name, t, spec[name][1], spec[name][0])
    lib = _library()
    opts = dict(device=xf.device, dtype=f32)
    ws = torch.empty(*spec["ws"][0], **opts)
    dwk = torch.empty(L, D, D, **opts)
    dwv = torch.empty(L, D, D, **opts)
    dbkv = torch.empty(2, L, D, **opts)
    status = lib.rg_cond_ctx_backward_b(
        xn.data_ptr(), dk.data_ptr(), dv.data_ptr(), dbkv_part.data_ptr(),
        ws.data_ptr(), dwk.data_ptr(), dwv.data_ptr(), dbkv.data_ptr(),
        B * Np, D, L, row_tiles(B, Np), splits, _stream(xf))
    build.check(lib, "rg_cond_ctx", status)
    cond_ctx_backward_b.launches += 1
    return dwk, dbkv[0], dwv, dbkv[1]


cond_ctx_forward.launches = 0
cond_ctx_backward_a.launches = 0
cond_ctx_backward_b.launches = 0


# ---------------------------------------------------------- autograd + API

class CondContexts(torch.autograd.Function):
    """Contexts with the analytic backward.  ``plain`` runs the plain
    versions (any device) with products rounded to ``operand_dtype``;
    otherwise the kernels run (CUDA tensors only).  The plain versions
    compute in xf's dtype, or in float32 for a bf16 xf; the kernels read
    LayerNorm's and the biases' parameters as float32 and the weights as
    bf16.  Every gradient comes back in its input's dtype."""

    @staticmethod
    def forward(ctx, xf, cm, nv, ln_g, ln_b, wk, bk, wv, bv, num_heads,
                plain, operand_dtype):
        ctx.num_heads = num_heads
        ctx.plain = plain
        ctx.operand_dtype = operand_dtype
        ctx.dtypes = tuple(t.dtype for t in (xf, ln_g, ln_b, wk, bk, wv, bv))
        if plain:
            cd = torch.promote_types(xf.dtype, torch.float32)
            args = tuple(t.to(cd) for t in (xf, cm, nv, ln_g, ln_b, wk, bk,
                                            wv, bv))
            ctx.save_for_backward(*args)
            return cond_ctx_reference(*args, num_heads, operand_dtype)
        f32 = torch.float32
        cm, nv = cm.to(f32).contiguous(), nv.to(f32).contiguous()
        params = (ln_g.to(f32).contiguous(), ln_b.to(f32).contiguous(),
                  wk.to(torch.bfloat16).contiguous(), bk.to(f32).contiguous(),
                  wv.to(torch.bfloat16).contiguous(), bv.to(f32).contiguous())
        xf = xf.contiguous()
        out, saved = cond_ctx_forward(xf, cm, nv, *params, num_heads)
        ctx.save_for_backward(xf, cm, nv, *params, out, *saved)
        return out

    @staticmethod
    def backward(ctx, dctx):
        H = ctx.num_heads
        if ctx.plain:
            args = ctx.saved_tensors
            grads = cond_ctx_backward_reference(
                *args, dctx.to(args[0].dtype).contiguous(), H,
                ctx.operand_dtype)
        else:
            xf, cm, nv, g, b, wk, bk, wv, bv, out, *saved = ctx.saved_tensors
            dxf, dg, db, inter = cond_ctx_backward_a(
                xf, cm, nv, g, b, wk, bk, wv, bv, out, saved,
                dctx.float().contiguous(), H)
            grads = (dxf, dg, db) + cond_ctx_backward_b(xf, cm, g, b, saved,
                                                        inter)
        dxf, dg, db, dwk, dbk, dwv, dbv = (
            gr.to(dt) for gr, dt in zip(grads, ctx.dtypes))
        return (dxf, None, None, dg, db, dwk, dbk, dwv, dbv, None, None, None)


def pad_rows(xf: torch.Tensor, cm: Optional[torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xf (B, N, D) -> xf padded with zero rows to Np (a multiple of 8, at
    least 8), cm as (B, 1, 1) (ones when None) and the validity nv (B, Np,
    1), all in xf's dtype."""
    B, N, _ = xf.shape
    Np = max(-(-N // 8) * 8, 8)
    opts = dict(device=xf.device, dtype=xf.dtype)
    cm = (torch.ones(B, 1, 1, **opts) if cm is None
          else cm.reshape(B, 1, 1).to(**opts))
    nv = torch.zeros(B, Np, 1, **opts)
    nv[:, :N] = 1.0
    return Fn.pad(xf, (0, 0, 0, Np - N)), cm, nv


def cond_contexts(xf, cm, ln_g, ln_b, wk, bk, wv, bv,
                  num_heads: int) -> torch.Tensor:
    """All-layer per-head contexts (B, L, H, Dh, Dh) with gradients.

    xf (B, N, D) unpadded condition features; cm (B, 1, 1) or None;
    stacked per-layer parameters as in :func:`cond_ctx_reference`.  CPU
    tensors take the plain versions in their own dtype (float32 for a bf16
    xf); CUDA tensors launch the kernels (float32 or bf16 in, float32 out,
    bf16 products) or raise."""
    xf_p, cm3, nv = pad_rows(xf, cm)
    plain = xf.device.type == "cpu"
    return CondContexts.apply(xf_p, cm3, nv, ln_g, ln_b, wk, bk, wv, bv,
                              num_heads, plain, None)


def cond_contexts_plain(xf, cm, ln_g, ln_b, wk, bk, wv, bv, num_heads: int,
                        operand_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """:func:`cond_contexts` through the plain versions on any device, with
    products rounded to ``operand_dtype``: what the kernels are held
    against on the card (bf16)."""
    xf_p, cm3, nv = pad_rows(xf, cm)
    return CondContexts.apply(xf_p, cm3, nv, ln_g, ln_b, wk, bk, wv, bv,
                              num_heads, True, operand_dtype)
