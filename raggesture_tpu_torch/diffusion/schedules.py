"""Beta schedules, respacing and the precomputed schedule tables.  Port of
``raggesture_tpu/diffusion/schedules.py``: the ``linear``, ``cosine`` and
``scaled_linear`` betas, the zero-terminal-SNR rescale, and the whole
respacing grammar (``"ddimN"``, ``"fast27"``, ``"leading"``,
``"trailing"`` and comma-separated section counts, the shipped
``"15,15,8,6,6"`` -> 50 steps).  Tables are built in float64 with numpy and
handed to torch as float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Union

import numpy as np
import torch


def get_named_beta_schedule(name: str, num_steps: int) -> np.ndarray:
    """Float64 betas of a named schedule."""
    if name == "linear":
        scale = 1000.0 / num_steps
        return np.linspace(scale * 0.0001, scale * 0.02, num_steps,
                           dtype=np.float64)
    if name == "cosine":
        return betas_for_alpha_bar(
            num_steps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2)
    if name == "scaled_linear":
        beta_start, beta_end = 0.00085, 0.012
        return np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_steps,
                           dtype=np.float64) ** 2
    raise NotImplementedError(f"unknown beta schedule: {name}")


def betas_for_alpha_bar(num_steps: int, alpha_bar,
                        max_beta: float = 0.999) -> np.ndarray:
    """Betas that discretise the cumulative product ``alpha_bar(t)`` over
    t in [0, 1], each clipped at ``max_beta``."""
    return np.array([min(1 - alpha_bar((i + 1) / num_steps)
                         / alpha_bar(i / num_steps), max_beta)
                     for i in range(num_steps)], dtype=np.float64)


def rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Betas rescaled so that the terminal SNR is exactly zero
    (arXiv:2305.08891): sqrt(abar) shifted to end at 0 and scaled to keep
    its start."""
    abar_sqrt = np.sqrt(np.cumprod(1.0 - betas))
    first, last = abar_sqrt[0], abar_sqrt[-1]
    abar_sqrt = (abar_sqrt - last) * first / (first - last)
    abar = abar_sqrt ** 2
    return 1.0 - np.concatenate([abar[:1], abar[1:] / abar[:-1]])


def space_timesteps(num_timesteps: int,
                    section_counts: Union[str, Sequence[int]],
                    num_inference_timesteps: Optional[int] = None) -> set:
    """The original timesteps kept when respacing: ``"ddimN"`` (N steps at
    an integer stride from 0), ``"fast27"``, ``"leading"`` and
    ``"trailing"`` (``num_inference_timesteps`` steps), or section counts
    (a comma-separated string or a sequence), each section of the
    schedule's equal parts spanned by its count of evenly spaced steps."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for stride in range(1, num_timesteps):
                if len(range(0, num_timesteps, stride)) == desired:
                    return set(range(0, num_timesteps, stride))
            raise ValueError(f"cannot create exactly {desired} steps with "
                             f"an integer stride")
        if section_counts == "fast27":
            steps = space_timesteps(num_timesteps, "15,15,8,6,6")
            steps.remove(num_timesteps - 1)
            steps.add(num_timesteps - 3)
            return steps
        if section_counts == "leading":
            assert num_inference_timesteps is not None
            ratio = num_timesteps // num_inference_timesteps
            return set(int(s) for s in (np.arange(num_inference_timesteps)
                                        * ratio).round().astype(int))
        if section_counts == "trailing":
            assert num_inference_timesteps is not None
            ratio = num_timesteps / num_inference_timesteps
            steps = np.round(np.arange(num_timesteps, 0, -ratio)).astype(
                np.int64) - 1
            return set(int(s) for s in np.append(steps, 0))
        section_counts = [int(x) for x in section_counts.split(",")]
        if num_inference_timesteps is not None:
            assert sum(section_counts) == num_inference_timesteps
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(
                f"cannot divide section of {size} steps into {section_count}")
        frac_stride = 1 if section_count <= 1 else (size - 1) / (section_count - 1)
        cur = 0.0
        for _ in range(section_count):
            all_steps.append(start_idx + round(cur))
            cur += frac_stride
        start_idx += size
    return set(all_steps)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Per-timestep tables, float32, indexed by the spaced step index;
    ``timestep_map`` maps each row to the original timestep."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    alphas_cumprod_next: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    fixed_large_variance: torch.Tensor
    fixed_large_log_variance: torch.Tensor
    timestep_map: torch.Tensor
    num_timesteps: int
    original_num_steps: int

    def to(self, device) -> "DiffusionSchedule":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def _build_tables(betas: np.ndarray) -> dict:
    betas = np.asarray(betas, dtype=np.float64)
    assert betas.ndim == 1 and (betas > 0).all() and (betas <= 1).all()
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    alphas_cumprod_next = np.append(alphas_cumprod[1:], 0.0)
    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    fixed_large_variance = np.append(posterior_variance[1], betas[1:])
    return dict(
        betas=betas,
        alphas_cumprod=alphas_cumprod,
        alphas_cumprod_prev=alphas_cumprod_prev,
        alphas_cumprod_next=alphas_cumprod_next,
        sqrt_alphas_cumprod=np.sqrt(alphas_cumprod),
        sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - alphas_cumprod),
        log_one_minus_alphas_cumprod=np.log(1.0 - alphas_cumprod),
        sqrt_recip_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod),
        sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod - 1.0),
        posterior_variance=posterior_variance,
        posterior_log_variance_clipped=np.log(
            np.append(posterior_variance[1], posterior_variance[1:])),
        posterior_mean_coef1=betas * np.sqrt(alphas_cumprod_prev)
        / (1.0 - alphas_cumprod),
        posterior_mean_coef2=(1.0 - alphas_cumprod_prev) * np.sqrt(alphas)
        / (1.0 - alphas_cumprod),
        fixed_large_variance=fixed_large_variance,
        fixed_large_log_variance=np.log(fixed_large_variance),
    )


def make_schedule(beta_scheduler: str = "scaled_linear",
                  diffusion_steps: int = 1000,
                  respace: Optional[Union[str, Sequence[int]]] = None,
                  num_inference_timesteps: Optional[int] = None,
                  rescale_betas_zero_snr: bool = False,
                  device=None) -> DiffusionSchedule:
    """A (possibly respaced) schedule: over the kept original steps k_i,
    beta'_i = 1 - abar_{k_i} / abar_{k_{i-1}}.  ``rescale_betas_zero_snr``
    rescales the betas before the respacing."""
    betas = get_named_beta_schedule(beta_scheduler, diffusion_steps)
    if rescale_betas_zero_snr:
        betas = rescale_zero_terminal_snr(betas)
    if respace is not None:
        keep = space_timesteps(diffusion_steps, respace, num_inference_timesteps)
        base_abar = np.cumprod(1.0 - betas)
        timestep_map, new_betas = [], []
        last_abar = 1.0
        for i, abar in enumerate(base_abar):
            if i in keep:
                new_betas.append(1.0 - abar / last_abar)
                last_abar = abar
                timestep_map.append(i)
        betas = np.array(new_betas, dtype=np.float64)
        tmap = np.array(timestep_map, dtype=np.int64)
    else:
        tmap = np.arange(diffusion_steps, dtype=np.int64)
    tables = {k: torch.tensor(v, dtype=torch.float32, device=device)
              for k, v in _build_tables(betas).items()}
    return DiffusionSchedule(
        **tables,
        timestep_map=torch.tensor(tmap, device=device),
        num_timesteps=int(betas.shape[0]),
        original_num_steps=int(diffusion_steps),
    )
