"""Diffusion timestep samplers.  Port of
``raggesture_tpu/diffusion/samplers.py``: ``UniformSampler`` (the shipped
config's) and ``LossSecondMomentResampler``, importance sampling of the
timesteps by the second moment of their recent losses.

``sample_np`` draws on the host from a numpy ``RandomState`` and gives the
JAX package's timesteps and weights for the same state; ``sample`` draws on
a ``torch.Generator``.  The history is updated on the host after each step
from the step's per-sample losses.  The synced update gathers every
process's (t, loss) pairs first, in process order, as the JAX package
does (``parallel/mesh.py::all_gather_ragged``: the counts, the pairs
padded to the largest count, each rank's cut back), so that every rank
applies the same history in the same order; on one process the gather is
the identity.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


class ScheduleSampler:
    def weights(self) -> np.ndarray:
        raise NotImplementedError

    def _probs(self) -> np.ndarray:
        w = np.asarray(self.weights(), np.float64)
        return w / w.sum()

    def sample(self, generator: torch.Generator, batch: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(timesteps (B,) int64, importance weights (B,) float32), drawn
        on ``generator``'s device."""
        p = self._probs()
        t = torch.multinomial(torch.as_tensor(p, device=generator.device),
                              batch, replacement=True, generator=generator)
        iw = 1.0 / (len(p) * p[t.cpu().numpy()])
        return t, torch.as_tensor(iw, dtype=torch.float32, device=t.device)

    def sample_np(self, np_rng: np.random.RandomState, batch: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """(t (B,) int32, weights (B,) float32) drawn on the host."""
        p = self._probs()
        t = np_rng.choice(len(p), size=batch, p=p)
        iw = 1.0 / (len(p) * p[t])
        return t.astype(np.int32), iw.astype(np.float32)


class UniformSampler(ScheduleSampler):
    def __init__(self, num_timesteps: int):
        self.num_timesteps = num_timesteps
        self._weights = np.ones(num_timesteps)

    def weights(self) -> np.ndarray:
        return self._weights


def _process_gather(ts: np.ndarray, losses: np.ndarray):
    """Every process's (t, loss) pairs in process order: the identity on
    one process.  The losses travel as float64, bit for bit."""
    from ..parallel.mesh import all_gather_ragged

    t_all, l_all = all_gather_ragged([np.asarray(ts, np.int64),
                                      np.asarray(losses, np.float64)])
    return t_all, l_all


class LossSecondMomentResampler(ScheduleSampler):
    """p(t) proportional to sqrt(E[loss_t^2]) over the last
    ``history_per_term`` losses of t, with a ``uniform_prob`` floor, and
    uniform until every t has its history.  ``synced`` gathers every
    process's pairs before the update; ``gather_fn`` replaces the gather
    (tests)."""

    def __init__(self, num_timesteps: int, history_per_term: int = 10,
                 uniform_prob: float = 0.001, synced: bool = True,
                 gather_fn=None):
        self.num_timesteps = num_timesteps
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob
        self.synced = synced
        self._gather = gather_fn or _process_gather
        self._loss_history = np.zeros((num_timesteps, history_per_term),
                                      np.float64)
        self._loss_counts = np.zeros(num_timesteps, np.int64)

    def _warmed_up(self) -> bool:
        return bool((self._loss_counts == self.history_per_term).all())

    def weights(self) -> np.ndarray:
        if not self._warmed_up():
            return np.ones(self.num_timesteps, np.float64)
        w = np.sqrt(np.mean(self._loss_history ** 2, axis=-1))
        w /= w.sum()
        w *= 1 - self.uniform_prob
        w += self.uniform_prob / len(w)
        return w

    def update_with_losses(self, ts, losses) -> None:
        """Append each (t, loss) to t's history, the oldest dropped once
        it is full."""
        ts = np.asarray(torch.as_tensor(ts).cpu())
        losses = np.asarray(torch.as_tensor(losses).detach().cpu(),
                            np.float64)
        if self.synced:
            ts, losses = self._gather(ts, losses)
        for t, loss in zip(np.asarray(ts).tolist(),
                           np.asarray(losses).tolist()):
            if self._loss_counts[t] == self.history_per_term:
                self._loss_history[t, :-1] = self._loss_history[t, 1:]
                self._loss_history[t, -1] = loss
            else:
                self._loss_history[t, self._loss_counts[t]] = loss
                self._loss_counts[t] += 1


def build_sampler(name: str, num_timesteps: int) -> ScheduleSampler:
    if name == "uniform":
        return UniformSampler(num_timesteps)
    if name == "loss-second-moment":
        return LossSecondMomentResampler(num_timesteps)
    raise NotImplementedError(f"unknown schedule sampler: {name}")
