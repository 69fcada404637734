"""RAG-Gesture in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package ``raggesture_tpu`` (the reference it is tested
against).  Module names follow the JAX package so that each counterpart is
easy to find.  The package imports ``torch`` and never ``jax``; the kernels
under ``ops/csrc/`` are compiled with ``nvcc`` at first use
(``ops/build.py``).

What is ported so far: plain deterministic (eta = 0) DDIM generation with the
scale-function condition mixing and the four-part VAE decode
(``models/architecture.py::StagedGenerator.sample``).
"""
