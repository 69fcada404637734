"""RAG-Gesture in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package ``raggesture_tpu`` (the reference it is tested
against).  Module names follow the JAX package so that each counterpart is
easy to find.  The package imports ``torch`` and never ``jax``; the kernels
under ``ops/csrc/`` are compiled with ``nvcc`` at first use
(``ops/build.py``).

What is ported so far: deterministic (eta = 0) DDIM generation with the
scale-function condition mixing and the four-part VAE decode, plain or with
the inference options (retrieval-guided sampling with the DDIM inversion of
exemplars, outpaint, the long-form prev-latent handoff), through the cached
layer kernel, the split blocks or the uncached denoiser call
(``models/architecture.py::StagedGenerator``), the denoiser's default
training step (``train/loop.py::make_train_step``), and the tools
``python -m raggesture_tpu_torch.tools.<name>``: ``visualize`` (serving,
with its config, BEAT2 window cache, data loader and retrieval database),
``longform_synthesis``, ``train`` (data-parallel with ``--distributed``,
``parallel/mesh.py``), ``train_vae`` (the part VAEs,
``models/vae_architecture.py``), and ``evaluate`` with
``evaluate_divonly`` and ``evaluate_mm`` (SMPL-X FK in ``models/smplx.py``,
the FGD embedder in ``models/eval_fgd.py``, the metrics in ``eval/``).
"""
