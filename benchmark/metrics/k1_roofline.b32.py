"""K1's share of its roofline (ops/decoder_layer.py, csrc/decoder_layer.cu):
the bound time of every decoder-layer call of the traced window's clips
(counts/k1.py, bf16 peak) over the device time of the kernels named in
_sampling.K1_KERNELS."""

from benchmark.metrics._sampling import k1_roofline as read  # noqa: F401
