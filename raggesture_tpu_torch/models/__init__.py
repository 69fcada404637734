"""Modules of the denoiser, the codec, the sampling orchestration, and
evaluation's SMPL-X body model and FGD embedder."""
