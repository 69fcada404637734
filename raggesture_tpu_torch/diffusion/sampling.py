"""The deterministic DDIM sampler.  Port of ``ddim_step`` and
``ddim_sample_loop`` of ``raggesture_tpu/diffusion/sampling.py`` for
eta = 0, as a Python loop.

``model_fn(x, t_orig, step_idx) -> model_output``: x (B, T, D) latents,
t_orig (B,) original-scale timesteps, step_idx the spaced step index (it
indexes per-step tables such as the scale-function coefficients).
"""

from __future__ import annotations

from typing import Callable

import torch

from . import gaussian as G
from .gaussian import MeanType, VarType
from .schedules import DiffusionSchedule

ModelFn = Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]


def _model_call(model_fn: ModelFn, sched: DiffusionSchedule, x, t, step_idx):
    return model_fn(x, sched.timestep_map[t], step_idx)


def ddim_step(model_fn: ModelFn, sched: DiffusionSchedule, x, t, step_idx, *,
              mean_type=MeanType.START_X, var_type=VarType.FIXED_LARGE,
              eta: float = 0.0, cfg_scale: float = 0.0):
    """One deterministic DDIM update (eq. 12 with sigma = 0)."""
    if eta != 0.0:
        raise NotImplementedError("only deterministic DDIM (eta = 0) is ported")
    out = G.p_mean_variance(sched, _model_call(model_fn, sched, x, t, step_idx),
                            x, t, mean_type=mean_type, var_type=var_type,
                            cfg_scale=cfg_scale)
    nd = x.dim()
    abar_prev = G._extract(sched.alphas_cumprod_prev, t, nd)
    mean_pred = (out.pred_xstart * torch.sqrt(abar_prev)
                 + torch.sqrt(1 - abar_prev) * out.eps)
    return mean_pred, out


def ddim_sample_loop(model_fn: ModelFn, sched: DiffusionSchedule,
                     noise: torch.Tensor, *, eta: float = 0.0,
                     mean_type=MeanType.START_X, var_type=VarType.FIXED_LARGE,
                     cfg_scale: float = 0.0) -> torch.Tensor:
    """The full DDIM chain from step S-1 down to 0."""
    x = noise
    B = noise.shape[0]
    for i in range(sched.num_timesteps - 1, -1, -1):
        t = torch.full((B,), i, dtype=torch.long, device=noise.device)
        x, _ = ddim_step(model_fn, sched, x, t, i, mean_type=mean_type,
                         var_type=var_type, eta=eta, cfg_scale=cfg_scale)
    return x
