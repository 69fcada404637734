"""The FFN block of a DecoderLayer with its stylization and residual, at
sampling time: kernel K8.

``fused_ffn`` replaces the TPU kernel
``raggesture_tpu/ops/pallas/linear_attention_kernel.py::fused_ffn`` (the
weights as an ``FFNWeights`` pack of the port's ``FFN``).  On CUDA tensors
it launches the three kernels of ``csrc/split_layer.cu``: ``ffn_up``
(linear1 and the GELU), ``ffn_down`` (linear2 and the row statistics of its
output) and ``cross_output`` (the stylization and the residual).  On CPU
tensors it runs ``fused_ffn_reference``, the plain PyTorch version, which
is also what the kernel is held against on the card.  float32 throughout.
The GELU is exact: ``torch.erf`` here and ``erff`` in the kernel (the TPU
kernel used an erf polynomial, |error| < 1.5e-7, because Mosaic has no
erf).
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn

from . import split_layer as S


class FFNWeights(S.Weights):
    """An FFN's tensors in the kernel's order: linear1, linear2, then the
    stylization's styl-norm and out_proj."""

    names = ("w1", "b1", "w2", "b2", "sn_g", "sn_b", "wo", "bo")

    def shapes(self, D):
        F = self.w1.shape[0]
        return [(F, D), (F,), (D, F), (D,)] + S.stylization_shapes(D)


def pack_ffn(block) -> FFNWeights:
    """The weight pack of a ``models.layers.FFN``."""
    return FFNWeights(*S.linear_params(block.linear1),
                      *S.linear_params(block.linear2),
                      *S.stylization_params(block.proj_out))


@torch.no_grad()
def fused_ffn_reference(
    x: torch.Tensor,        # (B, T, D)
    scale: torch.Tensor,    # (B, D) adaLN scale of each sequence
    shift: torch.Tensor,    # (B, D)
    w: FFNWeights,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_ffn` (the eager FFN with the
    adaLN rows given)."""
    y = Fn.linear(x, w.w1, w.b1)
    y = y * 0.5 * (1.0 + torch.erf(y * 0.7071067811865476))
    y = Fn.linear(y, w.w2, w.b2)
    return x + S.stylize(y, w, scale, shift)


def ffn_workspace_floats(rows: int, D: int, F: int) -> int:
    """Floats of K8's workspace for ``rows`` rows: f (rows, F), y (rows,
    D), then a (mean, M2) pair of y per row and 32-column tile, rounded up
    to whole float4s (what ``csrc/split_layer.cu::rg_ffn`` lays out)."""
    floats = rows * (F + D) + 2 * rows * (D // 32)
    return -(-floats // 4) * 4


def fused_ffn(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
              w: FFNWeights) -> torch.Tensor:
    """linear1 -> exact GELU -> linear2 -> stylization -> residual.

    CPU tensors take :func:`fused_ffn_reference`.  CUDA tensors launch the
    kernels (``fused_ffn.launches`` counts calls that did): x contiguous,
    ``scale``/``shift`` with contiguous rows (a batch stride of 0 shares one
    row), the pack's tensors float32 and contiguous on the same card;
    anything else raises."""
    if x.device.type == "cpu":
        return fused_ffn_reference(x, scale, shift, w)
    S.expect_shape("x", x, 3)
    B, T, D = x.shape
    F = w.w1.shape[0]
    if D % 32 or D > S.MAX_WIDTH or F % 32:
        raise ValueError(f"unsupported widths D {D}, F {F}: the kernels take "
                         f"multiples of 32, D up to {S.MAX_WIDTH}")
    S.expect_input("x", x, (B, T, D))
    scale_b = S.expect_batched("scale", scale, (B, D))
    shift_b = S.expect_batched("shift", shift, (B, D))
    ptrs = w.device_pointers(x, D)
    lib = S.library()
    out = torch.empty_like(x)
    ws = S.workspace(x, ffn_workspace_floats(B * T, D, F))
    S.check(lib.rg_ffn(
        x.data_ptr(), scale.data_ptr(), scale_b, shift.data_ptr(), shift_b,
        ptrs, out.data_ptr(), ws.data_ptr(), B, T, D, F, S.stream(x)))
    fused_ffn.launches += 1
    return out


fused_ffn.launches = 0
