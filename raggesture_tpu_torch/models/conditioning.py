"""Sampling-time condition mixing (the scale function) and the sampler
closures around a denoiser call.  Port of
``raggesture_tpu/models/conditioning.py``: the batch runs twice,
conditioned and unconditioned, and the two outputs mix with per-step
coefficients

    t > 100:  w = t/1000 * coarse_scale + 1, and a fair coin picks
              {both: w, retr: 1-w} or {text: w, none: 1-w}
    t <= 100: the fixed tuned coefficients (none = 1 - the other three)

    out = out_text*(both+text)*joint_scale + out_none*(retr+none)/joint_scale

and ``make_cfg_model_fn``, the B -> 2B model function of classifier-free
guidance (unconditioned rows first).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

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


def double_conditions(conds: Dict[str, torch.Tensor],
                      motion_mask: torch.Tensor,
                      query_masks: Optional[Dict[str, torch.Tensor]]):
    """The batch twice, conditioned and then with the conditions dropped:
    the doubled conditions, token mask (2B, T) and query masks, and the
    (2B, 1, 1) ``cond_mask``, ones then zeros."""
    conds2 = {k: torch.cat([v, v]) for k, v in conds.items()}
    mask2 = torch.cat([motion_mask, motion_mask])
    qm2 = (None if query_masks is None
           else {k: torch.cat([v, v]) for k, v in query_masks.items()})
    ones = torch.ones(motion_mask.shape[0], 1, 1, device=motion_mask.device)
    return conds2, mask2, qm2, torch.cat([ones, torch.zeros_like(ones)])


def make_mixed_model_fn(apply_fn: Callable, conds: Dict[str, torch.Tensor],
                        motion_mask: torch.Tensor,
                        query_masks: Optional[Dict[str, torch.Tensor]],
                        coef_table: torch.Tensor,
                        joint_scale: torch.Tensor) -> Callable:
    """A sampler ``model_fn(x, t_orig, step_idx)`` that runs the batch twice,
    conditioned and with the conditions dropped, and mixes the halves.
    ``apply_fn(latents, t_orig, motion_mask, conds, query_masks,
    cond_mask)`` is a denoiser call with its weights bound; the doubled
    conditions and masks are built here, once."""
    conds2, mask2, qm2, cond_mask = double_conditions(conds, motion_mask,
                                                      query_masks)

    def model_fn(x, t_orig, step_idx):
        out = apply_fn(torch.cat([x, x]), torch.cat([t_orig, t_orig]), mask2,
                       conds2, qm2, cond_mask)
        return mix_outputs(out, x.shape[0], coef_table, step_idx, joint_scale)

    return model_fn


def make_conditioned_model_fn(apply_fn: Callable,
                              conds: Dict[str, torch.Tensor],
                              motion_mask: torch.Tensor,
                              query_masks: Optional[Dict[str, torch.Tensor]]
                              ) -> Callable:
    """A plain conditioned ``model_fn`` (cond_mask 1, no mixing): the DDIM
    inversion of exemplars under their own conditions, and its check."""
    cond_mask = torch.ones(motion_mask.shape[0], 1, 1,
                           device=motion_mask.device)

    def model_fn(x, t_orig, step_idx):
        return apply_fn(x, t_orig, motion_mask, conds, query_masks, cond_mask)

    return model_fn


def make_cfg_model_fn(apply_fn: Callable, conds: Dict[str, torch.Tensor],
                      motion_mask: torch.Tensor,
                      query_masks: Optional[Dict[str, torch.Tensor]]
                      ) -> Callable:
    """The classifier-free-guidance ``model_fn``: B rows of x in, 2B rows
    out, the unconditioned (cond_mask 0) rows FIRST, as
    ``diffusion.gaussian.p_mean_variance`` takes them with ``cfg_scale >
    0``.  (The scale function above runs the conditioned half first; the
    two mechanisms are separate.)"""
    conds2, mask2, qm2, cm = double_conditions(conds, motion_mask,
                                               query_masks)
    cond_mask = cm.flip(0)

    def model_fn(x, t_orig, step_idx):
        return apply_fn(torch.cat([x, x]), torch.cat([t_orig, t_orig]), mask2,
                        conds2, qm2, cond_mask)

    return model_fn
