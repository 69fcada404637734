"""The benchmark of the PyTorch and CUDA port (``raggesture_tpu_torch``):
``python3 -m benchmark.run``; see ``README.md``."""
