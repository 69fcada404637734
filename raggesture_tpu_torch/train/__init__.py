"""Training of the denoiser (port of ``raggesture_tpu/train``)."""
