"""What the denoiser layer's block kernels K4, K5, K6, K7 and K8 share:
their library ``csrc/split_layer.cu`` (one translation unit: K5's and K8's
first two launches, the cross attentions' query-side kernels, whose
stylization launch ``cross_output`` ends K5 and K8 too, K6's key/value
kernels and a row-normalising kernel), the checks their wrappers make
before a launch, and the plain PyTorch pieces of their plain versions.

The wrappers live in ``self_attention.py`` (K5), ``cross_attention.py`` (K4,
K6, K7) and ``ffn.py`` (K8).  Where the JAX functions take a module's parameter
subtree, they take a ``Weights`` pack of the port's module: its own float32
tensors, an ``nn.Linear`` weight in its (out, in) layout, which the kernels
read in place (no copy).
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch
import torch.nn.functional as Fn

from . import build
from .linear_attention import NEG_MASK, apply_context

LN_EPS = 1e-5
MAX_HEAD_WIDTH = 128     # widest head; every head width divides it
CONTEXT_THREADS = 256    # threads of a K5 context block (self_context)
Q_PAD = 4                # floats of pad per q_sm row in a context block
MAX_SMEM = 232448        # 227 KB of shared memory a block
MAX_WIDTH = 1024         # widest row the row kernel holds in registers

_lib: List[ctypes.CDLL] = []


def library() -> ctypes.CDLL:
    """The loaded ``split_layer`` library (built first if need be)."""
    if not _lib:
        lib = build.load("split_layer")
        P, L, I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
        W = ctypes.POINTER(ctypes.c_void_p)
        lib.rg_self_attention.argtypes = [P, P, L, P, L, P, L, W, P, P,
                                          I, I, I, I, P]
        lib.rg_cross_attention_cached.argtypes = [P, P, L, P, L, P, L, P, L,
                                                  W, P, P, I, I, I, I, P]
        lib.rg_cross_block_cached.argtypes = [P, P, L, P, P, L, P, L, W, P,
                                              P, I, I, I, I, P]
        lib.rg_cross_attention.argtypes = [P, P, I, I, P, P, L, P, L, P, L,
                                           W, P, P, I, I, I, I, P]
        lib.rg_ffn.argtypes = [P, P, L, P, L, W, P, P, I, I, I, I, P]
        for fn in (lib.rg_self_attention, lib.rg_cross_attention_cached,
                   lib.rg_cross_attention, lib.rg_cross_block_cached,
                   lib.rg_ffn):
            fn.restype = ctypes.c_int
        _lib.append(lib)
    return _lib[0]


def check(status: int) -> None:
    build.check(library(), "rg_split_layer", status)


def stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def workspace(x: torch.Tensor, floats: int) -> torch.Tensor:
    return torch.empty(floats, device=x.device, dtype=torch.float32)


# ------------------------------------------------------- the launch checks

def _aligned(name: str, t: torch.Tensor) -> None:
    # the kernels read rows, biases and adaLN rows as float4
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel reads it 16 bytes at a time; "
                         f"its data is not 16-byte aligned")


def expect_shape(name: str, x: torch.Tensor, ndim: int) -> None:
    if x.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dimensions, got shape "
                         f"{tuple(x.shape)}")


def context_smem_bytes(T: int, Dh: int) -> int:
    """Shared memory of a K5 context block (``csrc/split_layer.cu``
    ``context_smem``): a head's T rows of q_sm (padded), k and v, its
    (Dh, Dh) context and a float a thread."""
    return 4 * (T * (3 * Dh + Q_PAD) + Dh * Dh + CONTEXT_THREADS)


def expect_widths(D: int, heads: int, T: int, self_attention: bool) -> None:
    """Raise unless the kernels take D-wide rows of ``heads`` heads and, for
    the self attention (``self_attention``), a head of T rows fits a
    context block's shared memory.  The other launches work in 16-row tiles
    and take any T."""
    if D % 32 or D > MAX_WIDTH or D % heads:
        raise ValueError(f"unsupported width {D} with {heads} heads: the "
                         f"kernels take multiples of 32 up to {MAX_WIDTH}")
    Dh = D // heads
    # whole heads a tile, 8 columns a work item, a whole number of context
    # threads to each of a head's columns
    if Dh % 8 or MAX_HEAD_WIDTH % Dh:
        raise ValueError(f"head width {Dh}: the attention kernels take 8, "
                         f"16, 32, 64 or 128")
    if self_attention and context_smem_bytes(T, Dh) > MAX_SMEM:
        raise ValueError(f"{T} tokens of head width {Dh} exceed the "
                         f"self-attention context block's {MAX_SMEM} bytes "
                         f"of shared memory")


def expect_rows(name: str, t: torch.Tensor, shape) -> int:
    """Raise unless ``t`` is a float32 CUDA tensor of ``shape`` (B, T, w)
    whose (b, t) rows are evenly spaced with contiguous elements (a column
    view of a wider mask qualifies); returns the row stride."""
    B, T, w = shape
    if (t.device.type != "cuda" or t.dtype != torch.float32
            or tuple(t.shape) != tuple(shape)
            or (w > 1 and t.stride(2) != 1)
            or (B > 1 and t.stride(0) != T * t.stride(1))):
        raise ValueError(
            f"{name}: the kernel takes a float32 CUDA tensor of shape "
            f"{tuple(shape)} with evenly spaced rows, got {t.dtype} "
            f"{tuple(t.shape)} strides {t.stride()} on {t.device}")
    return t.stride(1)


def expect_batched(name: str, t: torch.Tensor, shape) -> int:
    """Raise unless ``t`` is a float32 CUDA tensor of ``shape`` whose every
    batch element ``t[b]`` is contiguous and 16-byte aligned; returns the
    batch stride (0: one row shared by the batch, as ``expand`` gives)."""
    inner, step = [], 1
    for n in reversed(shape[1:]):
        inner.insert(0, step)
        step *= n
    if (t.device.type != "cuda" or t.dtype != torch.float32
            or tuple(t.shape) != tuple(shape)
            or list(t.stride()[1:]) != inner or t.stride(0) % 4):
        raise ValueError(
            f"{name}: the kernel takes a float32 CUDA tensor of shape "
            f"{tuple(shape)} whose batch elements are contiguous, got "
            f"{t.dtype} {tuple(t.shape)} strides {t.stride()} on {t.device}")
    _aligned(name, t)
    return t.stride(0)


def expect_input(name: str, t: torch.Tensor, shape) -> None:
    build.expect(name, t, torch.float32, shape)
    _aligned(name, t)


# ------------------------------------------------------ the weight packs

class Weights:
    """A block's float32 weight tensors in its kernel's order, named for the
    plain versions: the modules' own tensors (detached, not copied), so a
    pack is built once per generator and costs no memory.  On the card they
    are checked once, at the first launch, and passed as one C array of
    device pointers."""

    names: Tuple[str, ...] = ()

    def __init__(self, *tensors: torch.Tensor):
        if len(tensors) != len(self.names):
            raise ValueError(f"{type(self).__name__} takes {len(self.names)} "
                             f"tensors, got {len(tensors)}")
        self.tensors = tuple(t.detach() for t in tensors)
        for name, t in zip(self.names, self.tensors):
            setattr(self, name, t)
        self._checked = None
        self._pointers = None

    def shapes(self, D: int) -> List[tuple]:
        raise NotImplementedError

    def device_pointers(self, x: torch.Tensor, D: int):
        """The kernel's ``w``: every tensor checked (float32, contiguous,
        16-byte aligned, on x's card, shaped for width D) the first time."""
        if self._checked != (x.device, D):
            for name, t, shape in zip(self.names, self.tensors,
                                      self.shapes(D)):
                expect_input(f"{type(self).__name__}.{name}", t, shape)
                if t.device != x.device:
                    raise ValueError(f"{name} is on {t.device}, x on "
                                     f"{x.device}")
            self._pointers = (ctypes.c_void_p * len(self.tensors))(
                *[t.data_ptr() for t in self.tensors])
            self._checked = (x.device, D)
        return self._pointers


def linear_params(lin: torch.nn.Linear) -> list:
    return [lin.weight, lin.bias]


def norm_params(ln: torch.nn.LayerNorm) -> list:
    return [ln.weight, ln.bias]


def stylization_params(proj_out) -> list:
    """A StylizationBlock's styl-norm and out_proj: (g, b, W, bo)."""
    return norm_params(proj_out.norm) + linear_params(proj_out.out_proj)


def stylization_shapes(D: int) -> List[tuple]:
    return [(D,), (D,), (D, D), (D,)]


# --------------------------------------------- pieces of the plain versions

def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor
               ) -> torch.Tensor:
    """LayerNorm over the last dim (eps 1e-5), as the TPU kernels write it."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * g + b


def stylize(y: torch.Tensor, w: Weights, scale: torch.Tensor,
            shift: torch.Tensor) -> torch.Tensor:
    """A StylizationBlock after its adaLN projection (w's sn_g, sn_b, wo,
    bo): y (B, T, D) with the (B, D) scale and shift of each sequence."""
    h = (layer_norm(y, w.sn_g, w.sn_b) * (1.0 + scale[:, None])
         + shift[:, None])
    return Fn.linear(Fn.silu(h), w.wo, w.bo)


def feature_softmax(q: torch.Tensor, heads: int) -> torch.Tensor:
    """Softmax over each head's features, q (B, T, D) -> (B, T, H, Dh);
    the denominator clamped at 1e-30 as in the TPU kernels."""
    B, T, D = q.shape
    qh = q.reshape(B, T, heads, D // heads)
    qe = torch.exp(qh - qh.amax(-1, keepdim=True))
    return qe / qe.sum(-1, keepdim=True).clamp_min(1e-30)


def cached_cross_readout(w: Weights, xn_affine: torch.Tensor,
                         ctx: torch.Tensor, query_mask: torch.Tensor,
                         heads: int) -> torch.Tensor:
    """The query side of a cached-context cross attention: q from the
    normalised rows (w's wq, bq), softmax_f(q) ctx per head (ctx (B, H, Dh,
    Dh)), plus the output-side query-mask term (query_mask (B, T, 1))."""
    B, T, D = xn_affine.shape
    q = Fn.linear(xn_affine, w.wq, w.bq)
    y = apply_context(feature_softmax(q, heads), ctx).reshape(B, T, D)
    return y + (1.0 - query_mask) * NEG_MASK
