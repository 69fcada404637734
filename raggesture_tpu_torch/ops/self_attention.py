"""Self linear attention of one DecoderLayer with its stylization and
residual, at sampling time: kernel K5.

``fused_self_attention`` replaces the TPU kernel
``raggesture_tpu/ops/pallas/linear_attention_kernel.py::fused_self_attention``
(same argument order: x, src_mask, scale, shift, the block's weights, the
head count; the weights as a ``SelfAttentionWeights`` pack of the port's
``EfficientSelfAttention``).  On CUDA tensors it launches the three kernels
of ``csrc/split_layer.cu`` (whose header note says what bounds them and how
they are laid out): ``self_qkv`` (LayerNorm, q, k, v, the feature softmax
and the masks, per 16-row tile), ``self_context`` (the time softmax, the
per-head context and y, per sequence and head) and ``cross_output`` (the
stylization and the residual).  On CPU tensors it runs
``fused_self_attention_reference``, the plain PyTorch version of the same
function, which is also what the kernel is held against on the card.
float32 throughout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn

from . import split_layer as S
from .linear_attention import NEG_MASK, linear_attention


class SelfAttentionWeights(S.Weights):
    """An EfficientSelfAttention's tensors in the kernel's order: norm,
    query, key, value, then the stylization's styl-norm and out_proj."""

    names = ("ln_g", "ln_b", "wq", "bq", "wk", "bk", "wv", "bv",
             "sn_g", "sn_b", "wo", "bo")

    def shapes(self, D):
        return [(D,), (D,)] + [(D, D), (D,)] * 3 + S.stylization_shapes(D)


def pack_self_attention(block) -> SelfAttentionWeights:
    """The weight pack of a ``models.denoiser.EfficientSelfAttention``."""
    return SelfAttentionWeights(
        *S.norm_params(block.norm), *S.linear_params(block.query),
        *S.linear_params(block.key), *S.linear_params(block.value),
        *S.stylization_params(block.proj_out))


@torch.no_grad()
def fused_self_attention_reference(
    x: torch.Tensor,          # (B, T, D)
    src_mask: torch.Tensor,   # (B, T, 1) token validity
    scale: torch.Tensor,      # (B, D) adaLN scale of each sequence
    shift: torch.Tensor,      # (B, D) adaLN shift
    w: SelfAttentionWeights,
    num_heads: int,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_self_attention`."""
    m = src_mask
    xn = S.layer_norm(x, w.ln_g, w.ln_b)
    q = Fn.linear(xn, w.wq, w.bq)
    k = Fn.linear(xn, w.wk, w.bk) + (1.0 - m) * NEG_MASK
    v = Fn.linear(xn, w.wv, w.bv) * m
    # time softmax over each sequence's own rows (masked keys at -1e6)
    y = linear_attention(S.feature_softmax(q, num_heads),
                         torch.softmax(k, dim=1), v, num_heads)
    return x + S.stylize(y.reshape(x.shape), w, scale, shift)


def self_attention_workspace_floats(rows: int, D: int, heads: int) -> int:
    """Floats of K5's workspace for ``rows`` rows: q_sm | k | v (rows, 3D),
    y (rows, D), then a (mean, M2) pair of y per row and head, rounded up
    to whole float4s (what ``csrc/split_layer.cu::rg_self_attention`` lays
    out)."""
    floats = 4 * rows * D + 2 * rows * heads
    return -(-floats // 4) * 4


def fused_self_attention(
    x: torch.Tensor,
    src_mask: torch.Tensor,
    scale: torch.Tensor,
    shift: torch.Tensor,
    w: SelfAttentionWeights,
    num_heads: int,
) -> torch.Tensor:
    """Self linear attention + stylization + residual over B sequences.

    CPU tensors take :func:`fused_self_attention_reference`.  CUDA tensors
    launch the kernels (``fused_self_attention.launches`` counts calls that
    did): x contiguous, ``src_mask`` with evenly spaced rows, ``scale`` and
    ``shift`` with contiguous rows (a batch stride of 0 shares one row), the
    pack's tensors float32 and contiguous on the same card, D a multiple of
    32 up to 1024, a head width of 8, 16, 32, 64 or 128 and T tokens whose
    head fits a context block (``split_layer.context_smem_bytes`` at most
    227 KB: T <= 568 at head width 32, 274 at 64); anything else raises."""
    if x.device.type == "cpu":
        return fused_self_attention_reference(x, src_mask, scale, shift, w,
                                              num_heads)
    S.expect_shape("x", x, 3)
    B, T, D = x.shape
    S.expect_widths(D, num_heads, T, self_attention=True)
    S.expect_input("x", x, (B, T, D))
    mask_ld = S.expect_rows("src_mask", src_mask, (B, T, 1))
    scale_b = S.expect_batched("scale", scale, (B, D))
    shift_b = S.expect_batched("shift", shift, (B, D))
    ptrs = w.device_pointers(x, D)
    lib = S.library()
    out = torch.empty_like(x)
    ws = S.workspace(x, self_attention_workspace_floats(B * T, D,
                                                        num_heads))
    S.check(lib.rg_self_attention(
        x.data_ptr(), src_mask.data_ptr(), mask_ld, scale.data_ptr(),
        scale_b, shift.data_ptr(), shift_b, ptrs, out.data_ptr(),
        ws.data_ptr(), B, T, D, num_heads, S.stream(x)))
    fused_self_attention.launches += 1
    return out


fused_self_attention.launches = 0
