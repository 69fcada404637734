"""K2's share of its roofline (ops/mha.py, csrc/mha.cu): the bound time of
every attention of the traced window's decodes (counts/k2.py, TF32 peak)
over the device time of the kernels named in _sampling.K2_KERNELS."""

from benchmark.metrics._sampling import k2_roofline as read  # noqa: F401
