"""Gaussian diffusion math over the schedule tables.  Port of
``raggesture_tpu/diffusion/gaussian.py`` for the shipped sampler, an x0
(START_X) model with FIXED_LARGE variance and no classifier-free guidance,
and for training: ``q_sample`` and the regression target of every mean
type.

``t`` is always the spaced step index (a row of the tables); the model is
called with ``sched.timestep_map[t]``.
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import torch

from .schedules import DiffusionSchedule


class MeanType(enum.Enum):
    START_X = "start_x"
    EPSILON = "epsilon"
    V_PRED = "v_pred"
    PREVIOUS_X = "previous_x"


class VarType(enum.Enum):
    FIXED_LARGE = "fixed_large"
    FIXED_SMALL = "fixed_small"
    LEARNED = "learned"
    LEARNED_RANGE = "learned_range"


def _extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Per-batch rows of a 1-D table, right-broadcast to ``ndim``."""
    out = table[t]
    return out.reshape(out.shape + (1,) * (ndim - out.dim()))


def q_sample(sched: DiffusionSchedule, x_start, t, noise):
    """A draw of q(x_t | x_0) with the given noise."""
    nd = x_start.dim()
    return (_extract(sched.sqrt_alphas_cumprod, t, nd) * x_start
            + _extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * noise)


def get_v(sched: DiffusionSchedule, x_start, eps, t):
    nd = x_start.dim()
    return (_extract(sched.sqrt_alphas_cumprod, t, nd) * eps
            - _extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * x_start)


def training_target(sched: DiffusionSchedule, mean_type: MeanType, x_start,
                    x_t, noise, t):
    """The regression target of a mean type."""
    if mean_type == MeanType.START_X:
        return x_start
    if mean_type == MeanType.EPSILON:
        return noise
    if mean_type == MeanType.V_PRED:
        return get_v(sched, x_start, noise, t)
    if mean_type == MeanType.PREVIOUS_X:
        return q_posterior_mean_variance(sched, x_start, x_t, t)[0]
    raise NotImplementedError(mean_type)


def q_posterior_mean_variance(sched: DiffusionSchedule, x_start, x_t, t):
    nd = x_t.dim()
    mean = (_extract(sched.posterior_mean_coef1, t, nd) * x_start
            + _extract(sched.posterior_mean_coef2, t, nd) * x_t)
    return (mean, _extract(sched.posterior_variance, t, nd),
            _extract(sched.posterior_log_variance_clipped, t, nd))


def predict_eps_from_xstart(sched: DiffusionSchedule, x_t, t, pred_xstart):
    nd = x_t.dim()
    return ((_extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t
             - pred_xstart)
            / _extract(sched.sqrt_recipm1_alphas_cumprod, t, nd))


class PMeanVar(NamedTuple):
    mean: torch.Tensor
    variance: torch.Tensor
    log_variance: torch.Tensor
    pred_xstart: torch.Tensor
    eps: torch.Tensor


def p_mean_variance(sched: DiffusionSchedule, model_output: torch.Tensor,
                    x: torch.Tensor, t: torch.Tensor,
                    mean_type: MeanType = MeanType.START_X,
                    var_type: VarType = VarType.FIXED_LARGE,
                    cfg_scale: float = 0.0) -> PMeanVar:
    """p(x_{t-1} | x_t) statistics from the model output."""
    if (mean_type != MeanType.START_X or var_type != VarType.FIXED_LARGE
            or cfg_scale != 0.0):
        raise NotImplementedError(
            f"only START_X / FIXED_LARGE without guidance is ported, got "
            f"{mean_type} / {var_type} / cfg_scale {cfg_scale}")
    nd = x.dim()
    var = _extract(sched.fixed_large_variance, t, nd)
    log_var = _extract(sched.fixed_large_log_variance, t, nd)
    pred_xstart = model_output
    eps = predict_eps_from_xstart(sched, x, t, pred_xstart)
    mean, _, _ = q_posterior_mean_variance(sched, pred_xstart, x, t)
    return PMeanVar(mean, var, log_var, pred_xstart, eps)
