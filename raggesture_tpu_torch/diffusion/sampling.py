"""The deterministic DDIM samplers: plain (with the in-seq overwrite of
outpainting and the long-form handoff), inversion, and insertion-guided.
Port of ``ddim_step``, ``ddim_sample_loop``, ``ddim_reverse_step``,
``ddim_reverse_sample_loop``, ``guidance_update`` and
``ddim_guided_sample_loop`` of ``raggesture_tpu/diffusion/sampling.py``
for eta = 0, as Python loops.

``model_fn(x, t_orig, step_idx) -> model_output``: x (B, T, D) latents,
t_orig (B,) original-scale timesteps, step_idx the spaced step index (it
indexes per-step tables such as the scale-function coefficients).

The random draws are arguments: the in-seq overwrite's q_sample noise is
one bulk (S, B, T, D) draw (``in_seq_noise``), as the JAX package draws it
outside its scan; a ``torch.Generator`` draws it when it is not given.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from . import gaussian as G
from .gaussian import MeanType, VarType
from .schedules import DiffusionSchedule

ModelFn = Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]


def _model_call(model_fn: ModelFn, sched: DiffusionSchedule, x, t, step_idx):
    return model_fn(x, sched.timestep_map[t], step_idx)


def _deterministic(eta: float) -> None:
    if eta != 0.0:
        raise NotImplementedError("only deterministic DDIM (eta = 0) is ported")


def ddim_step(model_fn: ModelFn, sched: DiffusionSchedule, x, t, step_idx, *,
              mean_type=MeanType.START_X, var_type=VarType.FIXED_LARGE,
              eta: float = 0.0, cfg_scale: float = 0.0):
    """One deterministic DDIM update (eq. 12 with sigma = 0)."""
    _deterministic(eta)
    out = G.p_mean_variance(sched, _model_call(model_fn, sched, x, t, step_idx),
                            x, t, mean_type=mean_type, var_type=var_type,
                            cfg_scale=cfg_scale)
    nd = x.dim()
    abar_prev = G._extract(sched.alphas_cumprod_prev, t, nd)
    mean_pred = (out.pred_xstart * torch.sqrt(abar_prev)
                 + torch.sqrt(1 - abar_prev) * out.eps)
    return mean_pred, out


def ddim_reverse_step(model_fn: ModelFn, sched: DiffusionSchedule, x, t,
                      step_idx, *, mean_type=MeanType.START_X,
                      var_type=VarType.FIXED_LARGE, cfg_scale: float = 0.0):
    """One DDIM inversion update x_t -> x_{t+1}."""
    out = G.p_mean_variance(sched, _model_call(model_fn, sched, x, t, step_idx),
                            x, t, mean_type=mean_type, var_type=var_type,
                            cfg_scale=cfg_scale)
    abar_next = G._extract(sched.alphas_cumprod_next, t, x.dim())
    sample = (out.pred_xstart * torch.sqrt(abar_next)
              + torch.sqrt(1 - abar_next) * out.eps)
    return sample, out


def _draw_in_seq_noise(shape, noise, generator, device):
    if noise is not None:
        return noise.to(device)
    if generator is None:
        raise ValueError("the in-seq overwrite needs in_seq_noise or a "
                         "generator")
    return torch.randn(shape, generator=generator, device=device)


def _noised_in_seq_table(sched: DiffusionSchedule, in_seq: torch.Tensor,
                         noise: torch.Tensor):
    """(S, B, T, 1) mask and (S, B, T, D) q_sampled splice targets of every
    step, from ``in_seq`` (B, T, D) (the same each step) or (S, B, T, D)
    and the bulk draw ``noise`` (S, B, T, D).  The mask is the rows of
    the targets that are not all zero."""
    S = sched.num_timesteps
    if in_seq.dim() == 3:
        in_all = in_seq[None].expand((S,) + tuple(in_seq.shape))
    else:
        in_all = in_seq[:S]
    m_all = (in_all != 0).any(dim=-1, keepdim=True).to(in_all.dtype)
    shape = (S,) + (1,) * (in_all.dim() - 1)
    ab = sched.sqrt_alphas_cumprod.reshape(shape)
    om = sched.sqrt_one_minus_alphas_cumprod.reshape(shape)
    return m_all, in_all * ab + noise * om


def ddim_sample_loop(model_fn: ModelFn, sched: DiffusionSchedule,
                     noise: torch.Tensor, *, eta: float = 0.0,
                     mean_type=MeanType.START_X, var_type=VarType.FIXED_LARGE,
                     cfg_scale: float = 0.0,
                     in_seq: Optional[torch.Tensor] = None,
                     in_seq_noise: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """The full DDIM chain from step S-1 down to 0.  With ``in_seq`` its
    nonzero rows, q_sampled to each step's noise level, overwrite x before
    every model call (outpainting, the long-form handoff)."""
    _deterministic(eta)
    x = noise
    B = noise.shape[0]
    S = sched.num_timesteps
    if in_seq is not None:
        shape = (S,) + tuple(noise.shape)
        m_in, noised_in = _noised_in_seq_table(
            sched, in_seq, _draw_in_seq_noise(shape, in_seq_noise, generator,
                                              noise.device))
    for i in range(S - 1, -1, -1):
        t = torch.full((B,), i, dtype=torch.long, device=noise.device)
        if in_seq is not None:
            x = x * (1.0 - m_in[i]) + noised_in[i] * m_in[i]
        x, _ = ddim_step(model_fn, sched, x, t, i, mean_type=mean_type,
                         var_type=var_type, cfg_scale=cfg_scale)
    return x


def ddim_reverse_sample_loop(model_fn: ModelFn, sched: DiffusionSchedule,
                             x_start: torch.Tensor, *,
                             mean_type=MeanType.START_X,
                             var_type=VarType.FIXED_LARGE,
                             cfg_scale: float = 0.0) -> torch.Tensor:
    """DDIM inversion from step 0 up to S-1: (S, B, T, D), the latent after
    each step, clean to noisy, as insertion guidance consumes them."""
    x = x_start
    B = x_start.shape[0]
    steps = []
    for i in range(sched.num_timesteps):
        t = torch.full((B,), i, dtype=torch.long, device=x_start.device)
        x, _ = ddim_reverse_step(model_fn, sched, x, t, i, mean_type=mean_type,
                                 var_type=var_type, cfg_scale=cfg_scale)
        steps.append(x)
    return torch.stack(steps)


def guidance_update(x: torch.Tensor, inverted_latent: torch.Tensor,
                    n_iters: int, lr: float) -> torch.Tensor:
    """``n_iters`` literal gradient-descent steps on MSE(x * mask,
    inverted_latent) with respect to x, the mask being the rows of
    ``inverted_latent`` that are not all zero."""
    mask = (inverted_latent != 0).any(dim=-1, keepdim=True).to(x.dtype)
    for _ in range(int(n_iters)):
        with torch.enable_grad():
            xq = x.detach().requires_grad_(True)
            loss = ((xq * mask - inverted_latent) ** 2).mean()
            (g,) = torch.autograd.grad(loss, xq)
        x = x - lr * g
    return x


def ddim_guided_sample_loop(model_fn: ModelFn, sched: DiffusionSchedule,
                            noise: torch.Tensor, *,
                            inverted_latents: torch.Tensor,
                            guidance_iters, guidance_lr: float = 0.1,
                            eta: float = 0.0, mean_type=MeanType.START_X,
                            var_type=VarType.FIXED_LARGE,
                            cfg_scale: float = 0.0,
                            init_in_seq: Optional[torch.Tensor] = None,
                            in_seq_noise: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None,
                            exact_iters: bool = False) -> torch.Tensor:
    """Insertion-guided DDIM.  ``inverted_latents`` (S, B, T, D): each
    step's targets (zeros outside the inserted windows), clean to noisy;
    ``guidance_iters`` (S,) gradient-descent steps per step.

    At the first step (S-1) the overwrite takes ``init_in_seq`` (the
    long-form handoff; zeros when None) and no guidance runs; at every
    later step the targets ``inverted_latents[i]``, q_sampled with the bulk
    draw, overwrite their rows before the model call.  Those rows are the
    only ones the guidance's gradient reaches, so the default skips it;
    ``exact_iters=True`` runs it literally (``guidance_update``) and gives
    the same result."""
    _deterministic(eta)
    B = noise.shape[0]
    S = sched.num_timesteps
    iters = torch.as_tensor(guidance_iters).tolist()
    if init_in_seq is None:
        init_in_seq = torch.zeros_like(noise)
    in_all = inverted_latents[:S].clone()
    in_all[S - 1] = init_in_seq
    m_all, noised_all = _noised_in_seq_table(
        sched, in_all, _draw_in_seq_noise(in_all.shape, in_seq_noise,
                                          generator, noise.device))
    x = noise
    for i in range(S - 1, -1, -1):
        t = torch.full((B,), i, dtype=torch.long, device=noise.device)
        if exact_iters:
            n_iter = 0 if i == S - 1 else iters[i]
            x = guidance_update(x, inverted_latents[i], n_iter, guidance_lr)
        x = x * (1.0 - m_all[i]) + noised_all[i] * m_all[i]
        x, _ = ddim_step(model_fn, sched, x, t, i, mean_type=mean_type,
                         var_type=var_type, cfg_scale=cfg_scale)
    return x
