"""The diffusion samplers: DDIM (plain, with the in-seq overwrite of
outpainting and the long-form handoff; stochastic with ``eta > 0``), DDIM
inversion, insertion-guided DDIM, and ancestral DDPM.  Port of
``ddim_step``, ``ddim_sample_loop``, ``ddim_reverse_step``,
``ddim_reverse_sample_loop``, ``guidance_update``,
``ddim_guided_sample_loop``, ``ddpm_step`` and ``ddpm_sample_loop`` of
``raggesture_tpu/diffusion/sampling.py``, as Python loops, with the
prefix inpainting (``pre_seq``: DDPM and DDIM) and the root-translation
pinning (``transl_req``: DDPM) of the reference's ``p_sample``, and
``clip_denoised`` in every step and loop.

``model_fn(x, t_orig, step_idx) -> model_output``: x (B, T, D) latents,
t_orig (B,) original-scale timesteps, step_idx the spaced step index (it
indexes per-step tables such as the scale-function coefficients).

The random draws are arguments, each one bulk (S, B, T, D) draw indexed by
the spaced step: the in-seq overwrite's q_sample noise (``in_seq_noise``),
as the JAX package draws it outside its scan, the per-step noise of
stochastic DDIM and of DDPM (``step_noise``), the prefix's q_sample noise
(``pre_seq_noise``, (S, B, L, D)) and the pinned translations' noise
(``transl_noise``, (S, K, 2)).  A ``torch.Generator`` draws what is not
given, in that order.  The DDIM loops make no host sync, so a CUDA graph
can capture them.
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


def _draw(shape, given, generator, device, what: str):
    if given is not None:
        return given.to(device)
    if generator is None:
        raise ValueError(f"{what} needs its noise or a generator")
    return torch.randn(shape, generator=generator, device=device)


def _deterministic(eta: float, step_noise, generator) -> None:
    """Stochastic DDIM draws a noise per step: refuse eta > 0 without the
    noise or a generator to draw it."""
    if eta != 0.0 and step_noise is None and generator is None:
        raise NotImplementedError(
            f"DDIM with eta = {eta} needs step_noise or a generator")


def _step_noise(eta: float, shape, step_noise, generator, device):
    """The (S, B, T, D) per-step noise of stochastic DDIM (None at eta 0):
    ``step_noise`` or a draw from ``generator``."""
    if eta == 0.0:
        return None
    return _draw(shape, step_noise, generator, device,
                 f"DDIM with eta = {eta}")


def _nonzero(t: torch.Tensor, nd: int, dtype) -> torch.Tensor:
    return (t != 0).to(dtype).reshape((-1,) + (1,) * (nd - 1))


def _apply_pre_seq(sched: DiffusionSchedule, x, pre_seq, t, noise):
    """Prefix inpainting: x[:, :L] overwritten by q_sample of ``pre_seq``
    (B, L, D) with ``noise`` of its shape."""
    L = pre_seq.shape[1]
    return torch.cat([G.q_sample(sched, pre_seq, t, noise), x[:, L:]], dim=1)


def _transl_columns(transl_req) -> list:
    """The feature columns of ``transl_req``'s rows, read once on the
    host."""
    return [int(v) for v in torch.as_tensor(transl_req)[:, 0].tolist()]


def _apply_transl_req(sched: DiffusionSchedule, x, transl_req, columns, t,
                      noise):
    """Root-translation pinning: for each (feature, v0, v1) row k of
    ``transl_req`` (K, 3), the first two positions of that feature column
    overwritten by q_sample of (v0, v1) at t[0] with ``noise[k]`` (2,)."""
    x = x.clone()
    abar = sched.alphas_cumprod[t[0]]
    vals = transl_req[:, 1:3].to(x.dtype)
    x_t = vals * torch.sqrt(abar) + noise * torch.sqrt(1.0 - abar)
    for k, col in enumerate(columns):
        x[:, 0:2, col] = x_t[k][None, :]
    return x


def ddpm_step(model_fn: ModelFn, sched: DiffusionSchedule, x, t, step_idx,
              noise, *, mean_type=MeanType.START_X,
              var_type=VarType.FIXED_LARGE, cfg_scale: float = 0.0,
              clip_denoised: bool = False):
    """One ancestral step: the posterior mean plus exp(log_var / 2) noise
    (no noise at t = 0)."""
    out = G.p_mean_variance(sched, _model_call(model_fn, sched, x, t, step_idx),
                            x, t, mean_type=mean_type, var_type=var_type,
                            cfg_scale=cfg_scale, clip_denoised=clip_denoised)
    sample = (out.mean + _nonzero(t, x.dim(), x.dtype)
              * torch.exp(0.5 * out.log_variance) * noise)
    return sample, out


def ddim_step(model_fn: ModelFn, sched: DiffusionSchedule, x, t, step_idx, *,
              mean_type=MeanType.START_X, var_type=VarType.FIXED_LARGE,
              eta: float = 0.0, cfg_scale: float = 0.0,
              noise: Optional[torch.Tensor] = None,
              clip_denoised: bool = False):
    """One DDIM update (eq. 12); with ``eta > 0`` sigma-scaled ``noise``
    (x's shape) is added (none at t = 0)."""
    out = G.p_mean_variance(sched, _model_call(model_fn, sched, x, t, step_idx),
                            x, t, mean_type=mean_type, var_type=var_type,
                            cfg_scale=cfg_scale, clip_denoised=clip_denoised)
    nd = x.dim()
    abar_prev = G._extract(sched.alphas_cumprod_prev, t, nd)
    if eta == 0.0:
        mean_pred = (out.pred_xstart * torch.sqrt(abar_prev)
                     + torch.sqrt(1 - abar_prev) * out.eps)
        return mean_pred, out
    if noise is None:
        raise ValueError(f"DDIM with eta = {eta} needs the step's noise")
    abar = G._extract(sched.alphas_cumprod, t, nd)
    sigma = (eta * torch.sqrt((1 - abar_prev) / (1 - abar))
             * torch.sqrt(1 - abar / abar_prev))
    mean_pred = (out.pred_xstart * torch.sqrt(abar_prev)
                 + torch.sqrt(1 - abar_prev - sigma ** 2) * out.eps)
    return mean_pred + _nonzero(t, nd, x.dtype) * sigma * noise, out


def ddim_reverse_step(model_fn: ModelFn, sched: DiffusionSchedule, x, t,
                      step_idx, *, mean_type=MeanType.START_X,
                      var_type=VarType.FIXED_LARGE, cfg_scale: float = 0.0,
                      clip_denoised: bool = False):
    """One DDIM inversion update x_t -> x_{t+1}."""
    out = G.p_mean_variance(sched, _model_call(model_fn, sched, x, t, step_idx),
                            x, t, mean_type=mean_type, var_type=var_type,
                            cfg_scale=cfg_scale, clip_denoised=clip_denoised)
    abar_next = G._extract(sched.alphas_cumprod_next, t, x.dim())
    sample = (out.pred_xstart * torch.sqrt(abar_next)
              + torch.sqrt(1 - abar_next) * out.eps)
    return sample, out


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


def ddpm_sample_loop(model_fn: ModelFn, sched: DiffusionSchedule,
                     noise: torch.Tensor, *, mean_type=MeanType.START_X,
                     var_type=VarType.FIXED_LARGE, cfg_scale: float = 0.0,
                     clip_denoised: bool = False,
                     pre_seq: Optional[torch.Tensor] = None,
                     transl_req=None,
                     step_noise: Optional[torch.Tensor] = None,
                     pre_seq_noise: Optional[torch.Tensor] = None,
                     transl_noise: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """The full ancestral chain from step S-1 down to 0, ``step_noise[i]``
    the noise of step i.  Before each step's model call ``pre_seq``
    (B, L, D), q_sampled with ``pre_seq_noise[i]``, overwrites x[:, :L],
    and then each row (feature, v0, v1) of ``transl_req`` (K, 3), q_sampled
    with ``transl_noise[i, k]``, the first two positions of its feature
    column.  The pinned columns are read on the host once."""
    B = noise.shape[0]
    S = sched.num_timesteps
    dev = noise.device
    eps = _draw((S,) + tuple(noise.shape), step_noise, generator, dev,
                "DDPM sampling")
    if pre_seq is not None:
        pre_seq = pre_seq.to(dev)
        pre_eps = _draw((S,) + tuple(pre_seq.shape), pre_seq_noise,
                        generator, dev, "the prefix inpainting")
    if transl_req is not None:
        transl_req = torch.as_tensor(transl_req, device=dev)
        columns = _transl_columns(transl_req)
        tr_eps = _draw((S, transl_req.shape[0], 2), transl_noise, generator,
                       dev, "the translation pinning")
    x = noise
    for i in range(S - 1, -1, -1):
        t = torch.full((B,), i, dtype=torch.long, device=dev)
        if pre_seq is not None:
            x = _apply_pre_seq(sched, x, pre_seq, t, pre_eps[i])
        if transl_req is not None:
            x = _apply_transl_req(sched, x, transl_req, columns, t, tr_eps[i])
        x, _ = ddpm_step(model_fn, sched, x, t, i, eps[i],
                         mean_type=mean_type, var_type=var_type,
                         cfg_scale=cfg_scale, clip_denoised=clip_denoised)
    return x


def ddim_sample_loop(model_fn: ModelFn, sched: DiffusionSchedule,
                     noise: torch.Tensor, *, eta: float = 0.0,
                     mean_type=MeanType.START_X, var_type=VarType.FIXED_LARGE,
                     cfg_scale: float = 0.0, clip_denoised: bool = False,
                     in_seq: Optional[torch.Tensor] = None,
                     pre_seq: Optional[torch.Tensor] = None,
                     in_seq_noise: Optional[torch.Tensor] = None,
                     step_noise: Optional[torch.Tensor] = None,
                     pre_seq_noise: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """The full DDIM chain from step S-1 down to 0.  Before every model
    call ``pre_seq`` (B, L, D), q_sampled with ``pre_seq_noise[i]``,
    overwrites x[:, :L] (prefix inpainting), and then the nonzero rows of
    ``in_seq``, q_sampled to the step's noise level, overwrite theirs
    (outpainting, the long-form handoff).  With ``eta > 0``,
    ``step_noise[i]`` is step i's noise."""
    _deterministic(eta, step_noise, generator)
    x = noise
    B = noise.shape[0]
    S = sched.num_timesteps
    dev = noise.device
    shape = (S,) + tuple(noise.shape)
    if in_seq is not None:
        m_in, noised_in = _noised_in_seq_table(
            sched, in_seq, _draw(shape, in_seq_noise, generator, dev,
                                 "the in-seq overwrite"))
    eps = _step_noise(eta, shape, step_noise, generator, dev)
    if pre_seq is not None:
        pre_seq = pre_seq.to(dev)
        pre_eps = _draw((S,) + tuple(pre_seq.shape), pre_seq_noise,
                        generator, dev, "the prefix inpainting")
    for i in range(S - 1, -1, -1):
        t = torch.full((B,), i, dtype=torch.long, device=dev)
        if pre_seq is not None:
            x = _apply_pre_seq(sched, x, pre_seq, t, pre_eps[i])
        if in_seq is not None:
            x = x * (1.0 - m_in[i]) + noised_in[i] * m_in[i]
        x, _ = ddim_step(model_fn, sched, x, t, i, mean_type=mean_type,
                         var_type=var_type, cfg_scale=cfg_scale, eta=eta,
                         noise=None if eps is None else eps[i],
                         clip_denoised=clip_denoised)
    return x


def ddim_reverse_sample_loop(model_fn: ModelFn, sched: DiffusionSchedule,
                             x_start: torch.Tensor, *,
                             mean_type=MeanType.START_X,
                             var_type=VarType.FIXED_LARGE,
                             cfg_scale: float = 0.0,
                             clip_denoised: bool = False) -> torch.Tensor:
    """DDIM inversion from step 0 up to S-1: (S, B, T, D), the latent after
    each step, clean to noisy, as insertion guidance consumes them."""
    x = x_start
    B = x_start.shape[0]
    steps = []
    for i in range(sched.num_timesteps):
        t = torch.full((B,), i, dtype=torch.long, device=x_start.device)
        x, _ = ddim_reverse_step(model_fn, sched, x, t, i, mean_type=mean_type,
                                 var_type=var_type, cfg_scale=cfg_scale,
                                 clip_denoised=clip_denoised)
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
                            clip_denoised: bool = False,
                            init_in_seq: Optional[torch.Tensor] = None,
                            in_seq_noise: Optional[torch.Tensor] = None,
                            step_noise: Optional[torch.Tensor] = None,
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
    ``exact_iters=True`` runs it literally (``guidance_update``, which
    reads ``guidance_iters`` on the host) and gives the same result.  With
    ``eta > 0``, ``step_noise[i]`` is step i's noise."""
    _deterministic(eta, step_noise, generator)
    B = noise.shape[0]
    S = sched.num_timesteps
    if init_in_seq is None:
        init_in_seq = torch.zeros_like(noise)
    in_all = inverted_latents[:S].clone()
    in_all[S - 1] = init_in_seq
    m_all, noised_all = _noised_in_seq_table(
        sched, in_all, _draw(in_all.shape, in_seq_noise, generator,
                             noise.device, "the in-seq overwrite"))
    eps = _step_noise(eta, in_all.shape, step_noise, generator, noise.device)
    iters = torch.as_tensor(guidance_iters).tolist() if exact_iters else None
    x = noise
    for i in range(S - 1, -1, -1):
        t = torch.full((B,), i, dtype=torch.long, device=noise.device)
        if exact_iters:
            n_iter = 0 if i == S - 1 else iters[i]
            x = guidance_update(x, inverted_latents[i], n_iter, guidance_lr)
        x = x * (1.0 - m_all[i]) + noised_all[i] * m_all[i]
        x, _ = ddim_step(model_fn, sched, x, t, i, mean_type=mean_type,
                         var_type=var_type, cfg_scale=cfg_scale, eta=eta,
                         noise=None if eps is None else eps[i],
                         clip_denoised=clip_denoised)
    return x
