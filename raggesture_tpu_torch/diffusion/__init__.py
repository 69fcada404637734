"""Diffusion schedules, Gaussian diffusion math and the DDIM sampler."""
