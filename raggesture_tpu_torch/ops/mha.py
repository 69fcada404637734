"""Softmax multi-head attention of the codec decoders: kernel K2.

``fused_softmax_mha`` replaces the TPU kernel
``raggesture_tpu/ops/pallas/mha_kernel.py::fused_softmax_mha``.  On a CUDA
tensor it launches the hand-written kernel in ``csrc/mha.cu`` (whose header
note says what bounds it and how it is laid out); on a CPU tensor it runs
``softmax_mha_reference``, the plain PyTorch version of the same function,
which is also what the kernel is held against on the card.  The TPU kernel's
transposed (B, D, T) output was a Mosaic layout and is not part of the
function: both versions return (B, Tq, D).

Under autograd (an input that requires a gradient, grad mode on) the call
goes through ``SoftmaxMHA``, the counterpart of the JAX kernel's
``custom_vjp``: its forward is the kernel on the card (the plain version
on the CPU) and saves q, k and v; its backward recomputes the plain
version under autograd and returns its gradients, as JAX's ``_bwd``
recomputes through the XLA einsum path.  No kernel runs in the backward.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_DH_SUPPORTED = (8, 16, 32, 64)
_SMEM_LIMIT = 232448   # the 227 KB of shared memory a block may ask for


def softmax_mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          num_heads: int, scale: float) -> torch.Tensor:
    """softmax((q kᵀ) · scale) v per head.  q: (B, Tq, D); k, v: (B, Tk, D)."""
    B, Tq, D = q.shape
    Tk = k.shape[1]
    Dh = D // num_heads
    qh = q.reshape(B, Tq, num_heads, Dh)
    kh = k.reshape(B, Tk, num_heads, Dh)
    vh = v.reshape(B, Tk, num_heads, Dh)
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, vh).reshape(B, Tq, D)


def mha_supported(Tq: int, Tk: int, D: int, num_heads: int) -> bool:
    """Whether the kernel takes these shapes: at least one query and one
    key, a head width in ``_DH_SUPPORTED``, and a head's keys and values
    (rows padded to Dh + 4 floats) within a block's shared memory.  The
    caller routes anything else to the plain path, as the JAX package
    routes what ``mha_kernel.supported`` refuses."""
    if Tq < 1 or Tk < 1 or num_heads < 1 or D % num_heads:
        return False
    Dh = D // num_heads
    return Dh in _DH_SUPPORTED and 2 * Tk * (Dh + 4) * 4 <= _SMEM_LIMIT


def _library() -> ctypes.CDLL:
    lib = build.load("mha")
    fn = lib.rg_mha_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    return lib


def _kernel_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    num_heads: int, scale: float) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors (counted), or the plain
    version on CPU tensors."""
    if q.device.type == "cpu":
        return softmax_mha_reference(q, k, v, num_heads, scale)
    B, Tq, D = q.shape
    Tk = k.shape[1]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.device.type != "cuda" or t.dtype != torch.float32
                or not t.is_contiguous() or t.dim() != 3
                or t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"3-D float32 CUDA tensor, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if k.shape != (B, Tk, D) or v.shape != (B, Tk, D):
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if Tq < 1 or Tk < 1:
        raise ValueError(f"the kernel takes at least one query and one key, "
                         f"got {Tq} and {Tk}")
    Dh = D // num_heads
    if D % num_heads or Dh not in _DH_SUPPORTED:
        raise ValueError(f"head width {D}/{num_heads} is not one of "
                         f"{_DH_SUPPORTED}")
    # the kernel stages a head's keys and values, rows padded to Dh + 4
    if 2 * Tk * (Dh + 4) * 4 > _SMEM_LIMIT:
        raise ValueError(f"{Tk} keys of width {Dh} exceed the kernel's "
                         f"{_SMEM_LIMIT} bytes of shared memory")
    lib = _library()
    out = torch.empty_like(q)
    status = lib.rg_mha_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Tq, Tk, D, num_heads, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, "rg_mha", status)
    fused_softmax_mha.launches += 1
    return out


class SoftmaxMHA(torch.autograd.Function):
    """``fused_softmax_mha`` under autograd: the forward of
    :func:`_kernel_forward`, the backward the plain version's recomputed
    gradients (``SoftmaxMHA.backwards`` counts the backward calls)."""

    backwards = 0

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int, scale: float):
        ctx.save_for_backward(q, k, v)
        ctx.num_heads, ctx.scale = num_heads, scale
        return _kernel_forward(q, k, v, num_heads, scale)

    @staticmethod
    def backward(ctx, g):
        SoftmaxMHA.backwards += 1
        q, k, v = (t.detach().requires_grad_(True) for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = softmax_mha_reference(q, k, v, ctx.num_heads, ctx.scale)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g.float())
        return dq, dk, dv, None, None


def fused_softmax_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      num_heads: int, scale: float) -> torch.Tensor:
    """softmax((q kᵀ) · scale) v per head, float32, returns (B, Tq, D).

    CPU tensors take :func:`softmax_mha_reference`; CUDA tensors launch
    the kernel (``fused_softmax_mha.launches`` counts those launches) or
    raise on a shape or type the kernel does not take.  Where a gradient
    is wanted the call is :class:`SoftmaxMHA`'s: the same forward, the
    plain version's backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return SoftmaxMHA.apply(q, k, v, num_heads, scale)
    return _kernel_forward(q, k, v, num_heads, scale)


fused_softmax_mha.launches = 0
