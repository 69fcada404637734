"""Training the body-part VAEs, and the generic VAE architectures.  Port of
``raggesture_tpu/models/vae_architecture.py`` (``kl_divergence``,
``PoseVAE``, ``MotionVAE``, ``VAETrainConfig``, ``part_batch_features``,
``vae_training_loss``, ``make_vae_train_step``), after the reference's
registered ``PoseVAE``/``MotionVAE`` (mogen/models/architectures/
vae_architecture.py:14-117) and the part VAEs whose training the reference
does not ship (loaded at diffusion_transformer.py:151-188).

The step's random draws are explicit: ``eps`` (B, n_chunks, D), the
rsample at encode, is an argument or drawn from a ``torch.Generator``, so
a test can feed the JAX step's draw.  The training calls are
deterministic, as the JAX tool's (no dropout).  On the card the decoder's
unmasked attention runs kernel K2 under autograd
(``ops/mha.py::SoftmaxMHA``); the encoder's attention is masked by the
frame mask and takes the plain path, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from .codec import part_features
from .vae import TransformerVAE


def kl_divergence(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """-0.5 * sum(1 + logvar - mu^2 - exp(logvar))."""
    return -0.5 * torch.sum(1.0 + logvar - mu ** 2 - torch.exp(logvar))


class PoseVAE(nn.Module):
    """Per-frame pose VAE: the frames flattened, each pose (its last four
    contact features stripped) encoded and decoded on its own.
    ``encoder(pose) -> (mu, logvar)``, ``decoder(z) -> pose``."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module,
                 kl_div_loss_weight: Optional[float] = None):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.kl_div_loss_weight = kl_div_loss_weight

    def forward(self, motion: torch.Tensor, eps: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        B, T = motion.shape[:2]
        pose = motion.reshape(B * T, -1)[:, :-4]
        mu, logvar = self.encoder(pose)
        pred = self.decoder(mu + torch.exp(0.5 * logvar) * eps)
        loss = {"recon_loss": (pred - pose) ** 2}
        if self.kl_div_loss_weight is not None:
            loss["kl_div_loss"] = (kl_divergence(mu, logvar)
                                   * self.kl_div_loss_weight)
        return loss


class MotionVAE(nn.Module):
    """Sequence VAE: the masked reconstruction and the KL.
    ``encoder(motion, mask) -> (mu, logvar)``, ``decoder(z, mask)``."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module,
                 kl_div_loss_weight: Optional[float] = None):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.kl_div_loss_weight = kl_div_loss_weight

    def forward(self, motion: torch.Tensor, motion_mask: torch.Tensor,
                eps: torch.Tensor) -> Dict[str, torch.Tensor]:
        mu, logvar = self.encoder(motion, motion_mask)
        pred = self.decoder(mu + torch.exp(0.5 * logvar) * eps, motion_mask)
        recon = torch.mean((pred - motion) ** 2, dim=-1)
        recon = (recon * motion_mask).sum() / motion_mask.sum().clamp_min(1.0)
        loss = {"recon_loss": recon}
        if self.kl_div_loss_weight is not None:
            loss["kl_div_loss"] = (kl_divergence(mu, logvar)
                                   * self.kl_div_loss_weight)
        return loss


@dataclasses.dataclass(frozen=True)
class VAETrainConfig:
    part: str = "upper"            # upper | hands | face | lowertrans
    kl_weight: float = 1e-4
    recon_weight: float = 1.0
    vel_weight: float = 1.0        # the frame-difference reconstruction


def part_batch_features(batch: Dict[str, torch.Tensor], part: str
                        ) -> torch.Tensor:
    """One part's 6d features (B, T, nfeats) from a collated batch: the
    codec encode's composition (``codec.part_features``)."""
    return part_features(
        batch["motion_upper"], batch["motion_lower"], batch["motion_face"],
        batch["motion_hands"], batch["trans"], batch["facial"],
        batch["contact"])[part]


def vae_training_loss(vae: TransformerVAE, feats: torch.Tensor,
                      mask: Optional[torch.Tensor], eps: torch.Tensor,
                      cfg: VAETrainConfig
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The masked reconstruction, the masked velocity reconstruction and the
    KL (per element) of one part VAE, weighted by ``cfg``.  The frame
    ``mask`` (B, T) reaches the encoder too, so padded frames leave the
    chunk latents alone; ``eps`` (B, n_chunks, D) is the encode's rsample
    draw.  Returns (loss, logs: recon, vel, kl, loss)."""
    z, (mu, logvar) = vae.encode_to_dist(feats, eps, frame_mask=mask)
    rec = vae.decode(z, feats.shape[1])
    m = feats.new_ones(feats.shape[:2]) if mask is None else mask
    sq = torch.mean((rec - feats) ** 2, dim=-1)
    recon = (sq * m).sum() / m.sum().clamp_min(1.0)
    vel_sq = torch.mean((torch.diff(rec, dim=1) - torch.diff(feats, dim=1))
                        ** 2, dim=-1)
    vel = (vel_sq * m[:, 1:]).sum() / m[:, 1:].sum().clamp_min(1.0)
    kl = kl_divergence(mu, logvar) / mu.numel()
    loss = cfg.recon_weight * recon + cfg.vel_weight * vel + \
        cfg.kl_weight * kl
    return loss, {"recon": recon, "vel": vel, "kl": kl, "loss": loss}


def cosine_decay(lr: float, total_steps: int, alpha: float
                 ) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule(lr, total_steps, alpha)`` at an update
    count (the first update is count 0)."""
    def at(step: int) -> float:
        frac = min(step, total_steps) / total_steps
        return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac))
                     + alpha)
    return at


def make_vae_train_step(vae: TransformerVAE, optimizer: torch.optim.Optimizer,
                        cfg: VAETrainConfig, part: str,
                        schedule: Optional[Callable[[int], float]] = None):
    """``step(batch, step_idx, eps=None, generator=None) -> logs``: one
    update of ``vae`` by ``optimizer`` (Adam over its parameters, as the
    JAX tool's optax.adam), the learning rate ``schedule(step_idx)`` when
    given.  ``eps`` (B, n_chunks, D) is the rsample draw, else drawn from
    ``generator``.  The logs are detached 0-dim tensors."""
    c = vae.cfg

    def step(batch: Dict[str, torch.Tensor], step_idx: int,
             eps: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        feats = part_batch_features(batch, part)
        if eps is None:
            if generator is None:
                raise ValueError("the VAE step needs eps or a generator")
            eps = torch.randn(feats.shape[0],
                              feats.shape[1] // c.frame_chunk_size,
                              c.latent_dim, generator=generator,
                              device=feats.device, dtype=feats.dtype)
        if schedule is not None:
            for group in optimizer.param_groups:
                group["lr"] = schedule(step_idx)
        optimizer.zero_grad(set_to_none=True)
        loss, logs = vae_training_loss(vae, feats, batch.get("motion_mask"),
                                       eps, cfg)
        loss.backward()
        optimizer.step()
        return {k: v.detach() for k, v in logs.items()}

    return step
