"""Modules of the denoiser, the codec and the sampling orchestration."""
