"""Sampling-time condition mixing (the scale function).  Port of
``raggesture_tpu/models/conditioning.py``: the batch runs twice, conditioned
and unconditioned, and the two outputs mix with per-step coefficients

    t > 100:  w = t/1000 * coarse_scale + 1, and a fair coin picks
              {both: w, retr: 1-w} or {text: w, none: 1-w}
    t <= 100: the fixed tuned coefficients (none = 1 - the other three)

    out = out_text*(both+text)*joint_scale + out_none*(retr+none)/joint_scale
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..diffusion.schedules import DiffusionSchedule
from .denoiser import DenoiserConfig


@dataclasses.dataclass(frozen=True)
class ScaleFuncConfig:
    coarse_scale: float = 6.5
    both_coef: float = 0.52351
    text_coef: float = -0.28419
    retr_coef: float = 2.39872


def scale_func_table(sched: DiffusionSchedule, cfg: ScaleFuncConfig,
                     original_num_steps: int = 1000,
                     generator: Optional[torch.Generator] = None,
                     coins: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(S, 4) rows of (both, text, retr, none) coefficients, one per spaced
    step.  The coin flips come from ``coins`` ((S,) bool) when given, else
    from ``generator``."""
    t_orig = sched.timestep_map.float()
    S = sched.num_timesteps
    if coins is None:
        if generator is None:
            raise ValueError("scale_func_table needs a generator or coins")
        coins = torch.rand(S, generator=generator,
                           device=generator.device) < 0.5
    coins = coins.to(device=t_orig.device, dtype=torch.bool)
    w = t_orig / float(original_num_steps) * cfg.coarse_scale + 1.0
    zero = torch.zeros_like(w)
    hi = torch.where(coins[:, None],
                     torch.stack([w, zero, 1.0 - w, zero], dim=-1),
                     torch.stack([zero, w, zero, 1.0 - w], dim=-1))
    none_coef = 1.0 - cfg.both_coef - cfg.text_coef - cfg.retr_coef
    lo = torch.tensor([cfg.both_coef, cfg.text_coef, cfg.retr_coef, none_coef],
                      device=t_orig.device).expand(S, 4)
    return torch.where((t_orig > 100)[:, None], hi, lo)


def joint_scale_vector(cfg: DenoiserConfig,
                       per_joint_scale: Optional[Dict[str, float]] = None,
                       device=None) -> torch.Tensor:
    """Per-token output scale (T,); ones when not configured."""
    js = torch.ones(cfg.num_tokens, device=device)
    if per_joint_scale:
        for part, sl in cfg.part_slices().items():
            js[sl] = per_joint_scale["lowertransl" if part == "lowertrans"
                                     else part]
    return js


def mix_outputs(out2: torch.Tensor, B: int, coef_table: torch.Tensor,
                step_idx: int, joint_scale: torch.Tensor) -> torch.Tensor:
    """Combine the (2B, T, D) conditioned/unconditioned outputs."""
    out_text, out_none = out2[:B], out2[B:]
    both, text, retr, none = coef_table[step_idx]
    js = joint_scale[None, :, None]
    return out_text * (both + text) * js + out_none * (retr + none) / js
