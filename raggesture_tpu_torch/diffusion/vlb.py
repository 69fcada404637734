"""Variational-bound diagnostics: the KL terms and the decoder likelihood
of a diffusion model in bits per dimension, for likelihood evaluation and
debugging (the training loss does not use them).  Port of
``raggesture_tpu/diffusion/vlb.py``; ``calc_bpd_loop`` is a Python loop
whose per-step noise is an argument or a draw from a ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from . import gaussian as G
from .gaussian import MeanType, VarType
from .schedules import DiffusionSchedule


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL(N(mean1, exp(logvar1)) || N(mean2, exp(logvar2))), elementwise;
    any argument may be a float."""
    mean1, logvar1, mean2, logvar2 = (
        a if isinstance(a, torch.Tensor) else torch.tensor(a)
        for a in (mean1, logvar1, mean2, logvar2))
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def approx_standard_normal_cdf(x):
    """The tanh approximation of the standard normal CDF."""
    return 0.5 * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x, *, means, log_scales,
                                        bin_size: float = 1.0 / 127.5):
    """Log-likelihood of ``x`` under a Gaussian discretised to bins of
    ``bin_size``, the edge bins (x below -0.999 or above 0.999) open."""
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered + bin_size / 2))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered - bin_size / 2))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min,
                                   log_delta))


def _mean_flat(x):
    return x.reshape(x.shape[0], -1).mean(dim=1)


def vb_terms_bpd(model_output, sched: DiffusionSchedule, x_start, x_t, t, *,
                 mean_type=MeanType.START_X, var_type=VarType.FIXED_LARGE,
                 clip_denoised: bool = True) -> Dict[str, torch.Tensor]:
    """One step's term of the variational bound in bits per dimension:
    KL(q(x_{t-1} | x_t, x_0) || p(x_{t-1} | x_t)) where t > 0, the
    decoder's negative log-likelihood where t = 0.  ``output`` (B,) and the
    model's ``pred_xstart``."""
    true_mean, _, true_log_var = G.q_posterior_mean_variance(
        sched, x_start, x_t, t)
    out = G.p_mean_variance(sched, model_output, x_t, t, mean_type=mean_type,
                            var_type=var_type, clip_denoised=clip_denoised)
    kl = _mean_flat(normal_kl(true_mean, true_log_var, out.mean,
                              out.log_variance)) / math.log(2.0)
    decoder_nll = -discretized_gaussian_log_likelihood(
        x_start, means=out.mean, log_scales=0.5 * out.log_variance)
    decoder_nll = _mean_flat(decoder_nll) / math.log(2.0)
    return {"output": torch.where(t == 0, decoder_nll, kl),
            "pred_xstart": out.pred_xstart}


def prior_bpd(sched: DiffusionSchedule, x_start) -> torch.Tensor:
    """KL(q(x_T | x_0) || N(0, I)) in bits per dimension, (B,)."""
    B = x_start.shape[0]
    t = torch.full((B,), sched.num_timesteps - 1, dtype=torch.long,
                   device=x_start.device)
    abar = G._extract(sched.alphas_cumprod, t, x_start.dim())
    kl = normal_kl(x_start * torch.sqrt(abar), torch.log(1.0 - abar),
                   0.0, 0.0)
    return _mean_flat(kl) / math.log(2.0)


def calc_bpd_loop(model_fn, sched: DiffusionSchedule, x_start, *,
                  mean_type=MeanType.START_X, var_type=VarType.FIXED_LARGE,
                  clip_denoised: bool = True,
                  noise: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
    """The whole bound: every step from S-1 down to 0 noises ``x_start``
    with ``noise[i]`` (the step's (B, ...) noise; a (S, B, ...) draw from
    ``generator`` when not given) and calls ``model_fn(x_t, t_orig,
    step_idx)``.  Returns total_bpd (B,), prior_bpd (B,), and vb,
    xstart_mse and mse (S, B), rows in the order of the steps (S-1
    first)."""
    B = x_start.shape[0]
    S = sched.num_timesteps
    if noise is None:
        if generator is None:
            raise ValueError("calc_bpd_loop needs its noise or a generator")
        noise = torch.randn((S,) + tuple(x_start.shape), generator=generator,
                            device=x_start.device)
    vb, xstart_mse, mse = [], [], []
    for i in range(S - 1, -1, -1):
        t = torch.full((B,), i, dtype=torch.long, device=x_start.device)
        eps_i = noise[i].to(x_start.device)
        x_t = G.q_sample(sched, x_start, t, eps_i)
        out = vb_terms_bpd(model_fn(x_t, sched.timestep_map[t], i), sched,
                           x_start, x_t, t, mean_type=mean_type,
                           var_type=var_type, clip_denoised=clip_denoised)
        vb.append(out["output"])
        xstart_mse.append(_mean_flat((out["pred_xstart"] - x_start) ** 2))
        eps = G.predict_eps_from_xstart(sched, x_t, t, out["pred_xstart"])
        mse.append(_mean_flat((eps - eps_i) ** 2))
    vb = torch.stack(vb)
    pb = prior_bpd(sched, x_start)
    return {"total_bpd": vb.sum(dim=0) + pb, "prior_bpd": pb, "vb": vb,
            "xstart_mse": torch.stack(xstart_mse), "mse": torch.stack(mse)}
