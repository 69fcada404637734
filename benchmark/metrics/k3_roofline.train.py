"""K3's share of its roofline (ops/cond_ctx.py, csrc/cond_ctx.cu), its
three wrappers and three streams together: the bound time of every
stream's forward and backward in the traced window's steps (counts/k3.py,
bf16 peak) over the device time of _training.K3_KERNELS."""

from benchmark.metrics._training import k3_roofline as read  # noqa: F401
