"""The port's model built from a configuration's file, with the
benchmark's weights."""

from __future__ import annotations

import torch

from ..reference.params import make_weights


def arch_config(config: dict):
    """The port's ``ArchitectureConfig`` of the configuration's file."""
    from raggesture_tpu_torch.models.architecture import (
        ArchitectureConfig,
        DiffusionSpec,
    )
    from raggesture_tpu_torch.models.codec import CodecConfig
    from raggesture_tpu_torch.models.conditioning import ScaleFuncConfig
    from raggesture_tpu_torch.models.denoiser import DenoiserConfig

    codec = {k: v for k, v in config["codec"].items() if k != "pe_max_len"}
    return ArchitectureConfig(
        denoiser=DenoiserConfig(**config["denoiser"]),
        codec=CodecConfig(**codec),
        diffusion_train=DiffusionSpec(**config["diffusion_train"]),
        diffusion_test=DiffusionSpec(**config["diffusion_test"]),
        scale_func=ScaleFuncConfig(**config["scale_func"]))


def model(config: dict, seed: int, device):
    """The model with no weights made on ``device``, then the benchmark's
    weights of ``seed`` loaded strictly; in eval mode."""
    from raggesture_tpu_torch.models.architecture import MotionDiffusionModel

    with torch.device("meta"):
        m = MotionDiffusionModel(arch_config(config))
    m = m.to_empty(device=device)
    weights = make_weights(config, seed, device)
    m.load_state_dict(weights, strict=True)
    del weights
    return m.eval()
