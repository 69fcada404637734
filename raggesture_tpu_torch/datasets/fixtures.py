"""Synthetic fixtures: tiny batches and tiny configs for tests and dry runs.

Port of ``raggesture_tpu/datasets/fixtures.py``.  The reference's closest
analogue is its ``tiny=True`` dataset mode (one BEAT2 file,
mogen/datasets/beatx_dataset.py:159-167); since the BEAT2 data itself is a
download, the batches are synthesized with the field schema of
``BEATXDataset.__getitem__`` (beatx_dataset.py:1262-1295).  The arrays are
drawn from ``np.random.RandomState(seed)`` in the JAX module's order, so a
seed gives both packages the same values bit for bit.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..models.architecture import ArchitectureConfig, DiffusionSpec
from ..models.codec import (
    FACE_JOINTS,
    HANDS_JOINTS,
    LOWER_JOINTS,
    NUM_CONTACTS,
    NUM_EXPRESSIONS,
    TRANSL_DIM,
    UPPER_JOINTS,
    CodecConfig,
)
from ..models.denoiser import DenoiserConfig


def synthetic_batch(
    seed: int = 0,
    batch: int = 2,
    frames: int = 150,
    audio_frames: int = 64,
    text_dim: int = 768,
    audio_dim: int = 768,
    num_speakers: int = 25,
    dtype: torch.dtype = torch.float32,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, torch.Tensor]:
    """A batch with the BEATXDataset tensor schema on ``device`` (default
    the card); the float fields in ``dtype``, the lengths and speaker ids
    int32 as in the JAX module.  The ragged string fields (raw text,
    discourse tuples, gesture labels) are host data and not part of it."""
    dev = resolve_device(device)
    r = np.random.RandomState(seed)

    def rot(n_joints):
        # plausible small axis-angle poses
        return r.randn(batch, frames, n_joints * 3).astype(np.float32) * 0.2

    arrays = {
        "motion_upper": rot(UPPER_JOINTS),
        "motion_lower": rot(LOWER_JOINTS),
        "motion_face": rot(FACE_JOINTS),
        "motion_hands": rot(HANDS_JOINTS),
        "trans": r.randn(batch, frames, TRANSL_DIM).astype(np.float32) * 0.1,
        "facial": r.randn(batch, frames, NUM_EXPRESSIONS).astype(np.float32)
        * 0.1,
        "contact": (r.rand(batch, frames, NUM_CONTACTS) > 0.5).astype(
            np.float32),
        "motion_mask": np.ones((batch, frames), np.float32),
        "motion_length": np.full((batch,), frames, np.int32),
        "audio": r.randn(batch, audio_frames, audio_dim).astype(np.float32),
        "word": r.randn(batch, frames, text_dim).astype(np.float32),
        "speaker_ids": r.randint(0, num_speakers, (batch,)).astype(np.int32),
    }
    return {k: torch.from_numpy(v).to(
        device=dev, dtype=dtype if v.dtype == np.float32 else None)
        for k, v in arrays.items()}


def tiny_arch_config(frames: int = 30, latent: int = 32) -> ArchitectureConfig:
    """A few-thousand-parameter config (frames=30, chunk 15 -> 2 tokens a
    part, 11 in all)."""
    return ArchitectureConfig(
        denoiser=DenoiserConfig(
            latent_dim=latent, time_embed_dim=2 * latent, num_layers=2,
            num_heads=4, ff_size=2 * latent, text_latent_dim=24,
            audio_latent_dim=24, num_speakers=25, max_seq_len=frames,
            frame_chunk_size=15,
        ),
        codec=CodecConfig(
            latent_dim=latent, frame_chunk_size=15, num_frames=frames,
            num_layers=2, num_heads=2, lowertrans_num_heads=2,
            ff_size=2 * latent,
        ),
        diffusion_train=DiffusionSpec(diffusion_steps=100),
        diffusion_test=DiffusionSpec(
            diffusion_steps=100, respace="2,2,2,2,2",
            num_inference_timesteps=10),
    )


def tiny_batch(seed: int = 0, batch: int = 2, frames: int = 30,
               device: Optional[Union[str, torch.device]] = None
               ) -> Dict[str, torch.Tensor]:
    """:func:`synthetic_batch` at :func:`tiny_arch_config`'s widths."""
    return synthetic_batch(seed=seed, batch=batch, frames=frames,
                           audio_frames=8, text_dim=24, audio_dim=24,
                           device=device)


def full_arch_config() -> ArchitectureConfig:
    """The shipped basegesture_len150_beat configuration."""
    return ArchitectureConfig()
