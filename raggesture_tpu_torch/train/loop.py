"""The denoiser's training step: Adam with cosine decay over the denoiser,
the codec frozen.  Port of ``raggesture_tpu/train/loop.py``
(``OptimConfig``, ``param_labels``/``make_optimizer``,
``create_train_state``, ``make_train_step``, ``make_val_step``).

The JAX package freezes the codec as a parameter partition (its updates
set to zero); here the codec's parameters have ``requires_grad`` off and
the optimizer holds the denoiser's alone, so the codec stays bitwise
unchanged.  The step updates the model and the optimizer in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from ..diffusion.schedules import DiffusionSchedule
from ..models.architecture import MotionDiffusionModel, training_loss


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """The JAX package's OptimConfig, for what is ported: Adam at ``lr``
    with cosine decay to ``lr * min_lr_ratio`` over ``total_steps``."""

    lr: float = 1e-4
    min_lr_ratio: float = 1e-6
    total_steps: int = 100_000
    b1: float = 0.9
    b2: float = 0.999


def cosine_lr(cfg: OptimConfig, step: int) -> float:
    """``optax.cosine_decay_schedule(lr, total_steps, alpha=min_lr_ratio)``
    at update ``step`` (the first update is step 0 and uses ``lr``)."""
    frac = min(step, cfg.total_steps) / cfg.total_steps
    cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
    return cfg.lr * ((1.0 - cfg.min_lr_ratio) * cosine + cfg.min_lr_ratio)


@dataclasses.dataclass
class TrainState:
    model: MotionDiffusionModel
    optimizer: torch.optim.Adam
    optim_cfg: OptimConfig
    step: int = 0


def create_train_state(model: MotionDiffusionModel,
                       optim_cfg: OptimConfig = OptimConfig()) -> TrainState:
    """Freeze the codec and build Adam (eps 1e-8, as optax's) over the
    denoiser's parameters."""
    model.codec.requires_grad_(False)
    opt = torch.optim.Adam(model.denoiser.parameters(), lr=optim_cfg.lr,
                           betas=(optim_cfg.b1, optim_cfg.b2), eps=1e-8)
    return TrainState(model, opt, optim_cfg)


def make_train_step(sched_train: DiffusionSchedule):
    """The JAX package's ``make_train_step(..., fused_ctx=True)``: the step
    ``train_step(state, batch, generator=None, **draws) -> logs``, the
    training loss (draws as in ``training_loss``), its
    gradient, one Adam update at the step's cosine learning rate.  Logs:
    ``recon_loss``, ``mse_unweighted`` and ``grad_norm`` (the global norm
    of the denoiser's gradients), as 0-dim tensors."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   **draws) -> Dict[str, torch.Tensor]:
        model, opt = state.model, state.optimizer
        opt.zero_grad(set_to_none=True)
        loss, logs = training_loss(model, sched_train, batch, generator,
                                   **draws)
        loss.backward()
        grads = [p.grad for p in model.denoiser.parameters()
                 if p.grad is not None]
        logs = {k: v.detach() for k, v in logs.items()}
        logs["grad_norm"] = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        lr = cosine_lr(state.optim_cfg, state.step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        state.step += 1
        return logs

    return train_step


def make_val_step(sched_train: DiffusionSchedule):
    """The training loss without gradients: ``val_step(state, batch,
    generator=None, **draws) -> logs``."""

    @torch.no_grad()
    def val_step(state: TrainState, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None, **draws):
        return training_loss(state.model, sched_train, batch, generator,
                             **draws)[1]

    return val_step
