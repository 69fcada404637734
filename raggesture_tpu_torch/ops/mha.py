"""Softmax multi-head attention of the codec decoders: kernel K2.

``fused_softmax_mha`` replaces the TPU kernel
``raggesture_tpu/ops/pallas/mha_kernel.py::fused_softmax_mha``.  On a CUDA
tensor it launches the hand-written kernel in ``csrc/mha.cu`` (whose header
note says what bounds it and how it is laid out); on a CPU tensor it runs
``softmax_mha_reference``, the plain PyTorch version of the same function,
which is also what the kernel is held against on the card.  The TPU kernel's
transposed (B, D, T) output was a Mosaic layout and is not part of the
function: both versions return (B, Tq, D).
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_DH_SUPPORTED = (8, 16, 32, 64)
_SMEM_LIMIT = 48 * 1024


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


def _library() -> ctypes.CDLL:
    lib = build.load("mha")
    fn = lib.rg_mha_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    return lib


def fused_softmax_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      num_heads: int, scale: float) -> torch.Tensor:
    """softmax((q kᵀ) · scale) v per head, float32, returns (B, Tq, D).

    CPU tensors take :func:`softmax_mha_reference`; CUDA tensors launch
    the kernel (``fused_softmax_mha.launches`` counts those launches) or
    raise on a shape or type the kernel does not take."""
    if q.device.type == "cpu":
        return softmax_mha_reference(q, k, v, num_heads, scale)
    B, Tq, D = q.shape
    Tk = k.shape[1]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.device.type != "cuda" or t.dtype != torch.float32
                or not t.is_contiguous() or t.dim() != 3):
            raise ValueError(f"{name} must be a contiguous 3-D float32 CUDA "
                             f"tensor, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if k.shape != (B, Tk, D) or v.shape != (B, Tk, D):
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    Dh = D // num_heads
    if D % num_heads or Dh not in _DH_SUPPORTED:
        raise ValueError(f"head width {D}/{num_heads} is not one of "
                         f"{_DH_SUPPORTED}")
    if 2 * Tk * Dh * 4 > _SMEM_LIMIT:
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


fused_softmax_mha.launches = 0
