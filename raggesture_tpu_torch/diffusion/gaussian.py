"""Gaussian diffusion math over the schedule tables.  Port of
``raggesture_tpu/diffusion/gaussian.py``: ``q_sample``, the posterior, the
conversions between x0, eps, v and x_{t-1}, ``p_mean_variance`` for every
mean type (START_X, EPSILON, V_PRED, PREVIOUS_X) and variance type
(FIXED_LARGE, FIXED_SMALL, LEARNED, LEARNED_RANGE) with ``clip_denoised``,
``denoised_fn`` and classifier-free guidance, and the regression target of
every mean type.

``t`` is always the spaced step index (a row of the tables); the model is
called with ``sched.timestep_map[t]``.
"""

from __future__ import annotations

import enum
from typing import Callable, NamedTuple, Optional

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


def predict_xstart_from_eps(sched: DiffusionSchedule, x_t, t, eps):
    nd = x_t.dim()
    return (_extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t
            - _extract(sched.sqrt_recipm1_alphas_cumprod, t, nd) * eps)


def predict_eps_from_xstart(sched: DiffusionSchedule, x_t, t, pred_xstart):
    nd = x_t.dim()
    return ((_extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t
             - pred_xstart)
            / _extract(sched.sqrt_recipm1_alphas_cumprod, t, nd))


def predict_xstart_from_v(sched: DiffusionSchedule, x_t, t, v):
    nd = x_t.dim()
    return (_extract(sched.sqrt_alphas_cumprod, t, nd) * x_t
            - _extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * v)


def predict_eps_from_v(sched: DiffusionSchedule, x_t, t, v):
    nd = x_t.dim()
    return (_extract(sched.sqrt_alphas_cumprod, t, nd) * v
            + _extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * x_t)


def predict_xstart_from_xprev(sched: DiffusionSchedule, x_t, t, xprev):
    nd = x_t.dim()
    c1 = _extract(sched.posterior_mean_coef1, t, nd)
    c2 = _extract(sched.posterior_mean_coef2, t, nd)
    return (1.0 / c1) * xprev - (c2 / c1) * x_t


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
                    cfg_scale: float = 0.0, clip_denoised: bool = False,
                    denoised_fn: Optional[Callable] = None) -> PMeanVar:
    """p(x_{t-1} | x_t) statistics from the model output.

    With ``cfg_scale > 0`` (classifier-free guidance) ``x`` and ``t`` are
    B rows and ``model_output`` 2B, the unconditioned rows first
    (``conditioning.make_cfg_model_fn``); the two mix in eps space and
    every statistic is B rows.  Guidance is for START_X and EPSILON only:
    LEARNED / LEARNED_RANGE variances and PREVIOUS_X / V_PRED means raise.
    The learned variances split the model output along axis 1 at x's
    width there (for the (B, T, D) latents that is the token axis, as in
    the JAX package).  ``denoised_fn`` and then ``clip_denoised`` (to
    [-1, 1]) process the x0 prediction, but V_PRED's, which is left
    unprocessed, as in the JAX package."""
    nd = x.dim()
    if cfg_scale > 0 and (
            var_type in (VarType.LEARNED, VarType.LEARNED_RANGE)
            or mean_type in (MeanType.PREVIOUS_X, MeanType.V_PRED)):
        raise NotImplementedError(
            f"classifier-free guidance is not supported for {var_type} / "
            f"{mean_type}")
    if var_type in (VarType.LEARNED, VarType.LEARNED_RANGE):
        C = x.shape[1]
        model_output, var_values = model_output[:, :C], model_output[:, C:]
        if var_type == VarType.LEARNED:
            log_var = var_values
        else:
            min_log = _extract(sched.posterior_log_variance_clipped, t, nd)
            max_log = _extract(torch.log(sched.betas), t, nd)
            frac = (var_values + 1) / 2
            log_var = frac * max_log + (1 - frac) * min_log
        var = torch.exp(log_var)
    elif var_type == VarType.FIXED_LARGE:
        var = _extract(sched.fixed_large_variance, t, nd)
        log_var = _extract(sched.fixed_large_log_variance, t, nd)
    else:
        var = _extract(sched.posterior_variance, t, nd)
        log_var = _extract(sched.posterior_log_variance_clipped, t, nd)

    def process_xstart(x0):
        if denoised_fn is not None:
            x0 = denoised_fn(x0)
        if clip_denoised:
            x0 = x0.clamp(-1.0, 1.0)
        return x0

    if mean_type == MeanType.PREVIOUS_X:
        pred_xstart = process_xstart(
            predict_xstart_from_xprev(sched, x, t, model_output))
        eps = predict_eps_from_xstart(sched, x, t, pred_xstart)
        return PMeanVar(model_output, var, log_var, pred_xstart, eps)
    if mean_type == MeanType.START_X:
        pred_xstart = process_xstart(model_output)
        if cfg_scale > 0:
            x0_uncond, x0_cond = pred_xstart.chunk(2, dim=0)
            eps_u = predict_eps_from_xstart(sched, x, t, x0_uncond)
            eps_c = predict_eps_from_xstart(sched, x, t, x0_cond)
            eps = eps_u + cfg_scale * (eps_c - eps_u)
            pred_xstart = predict_xstart_from_eps(sched, x, t, eps)
        else:
            eps = predict_eps_from_xstart(sched, x, t, pred_xstart)
    elif mean_type == MeanType.EPSILON:
        if cfg_scale > 0:
            eps_u, eps_c = model_output.chunk(2, dim=0)
            eps = eps_u + cfg_scale * (eps_c - eps_u)
        else:
            eps = model_output
        pred_xstart = process_xstart(predict_xstart_from_eps(sched, x, t, eps))
    elif mean_type == MeanType.V_PRED:
        eps = predict_eps_from_v(sched, x, t, model_output)
        pred_xstart = predict_xstart_from_eps(sched, x, t, eps)
    else:
        raise NotImplementedError(mean_type)
    mean, _, _ = q_posterior_mean_variance(sched, pred_xstart, x, t)
    return PMeanVar(mean, var, log_var, pred_xstart, eps)
