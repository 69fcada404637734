"""Training traffic: the denoiser's training step, fed back to back in a
closed loop from a set of synthetic windows held on the card.

The mix's file gives ``batch`` (samples a step), ``steps_per_call`` (the
configuration's ``runner.multi_step``: steps a call of the multi-step),
``windows`` (the synthetic training windows, made from the seed at
set-up), ``trace_requests`` (calls in the traced window) and ``limits``.
Call ``i`` of seed ``s`` takes rows of a permutation of the windows drawn
from the seed, in order, so that the rows of the first calls all differ,
and its draws (each part's encode noise, the timesteps, the latent noise,
the condition-dropout mask) from ``SeedSequence([s, i])``.  The
set-up's first calls are of 1 and 2 steps, then one of the mix's length;
the window's calls continue the same sequence.
"""

from __future__ import annotations

import numpy as np
import torch

from ..checks import training as checks
from ..systems import training as systems
from .sampling import draw_seed

PART_FEATS = {"upper": 13 * 3, "hands": 30 * 3, "face": 3, "lower": 9 * 3}
FIRST_CALLS = (1, 2)          # the set-up's first calls: steps 1, then 2-3


class Traffic:
    def __init__(self, params: dict, config: dict, seed: int):
        self.params = params
        self.seed = int(seed)
        self.batch = int(params["batch"])
        self.k = int(params["steps_per_call"])
        self.windows = int(params["windows"])
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 5]))
        self.order = rng.permutation(self.windows)
        self.warm = list(FIRST_CALLS) + [self.k]

    def _call(self, index: int, steps: int, first_step: int) -> dict:
        n = steps * self.batch
        pos = (first_step * self.batch + np.arange(n)) % self.windows
        return {"index": index, "steps": steps,
                "rows": self.order[pos].reshape(steps, self.batch),
                "draw_seed": draw_seed(self.seed, index + 1000, 6)}

    def warm_up_request(self, j: int) -> dict:
        """The set-up's calls: 1 step, 2 steps, then one of the mix's
        length (negative indices)."""
        return self._call(-1 - j, self.warm[j], sum(self.warm[:j]))

    def request(self, i: int) -> dict:
        return self._call(i, self.k, sum(self.warm) + i * self.k)

    def units(self, req: dict) -> int:
        return req["steps"] * self.batch


def dataset(config: dict, params: dict, seed: int, device) -> dict:
    """The synthetic windows on ``device``: axis-angle joints normal(0,
    0.3), translation, expressions and contacts normal(0, 1), text and
    audio features normal(0, 1), speakers uniform, every frame valid."""
    dc, cc = config["denoiser"], config["conditions"]
    N, F = int(params["windows"]), dc["max_seq_len"]
    g = torch.Generator(device=device).manual_seed(draw_seed(seed, 0, 7))

    def normal(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=device) * std

    d = {f"motion_{p}": normal(N, F, w, std=0.3)
         for p, w in PART_FEATS.items()}
    d.update(trans=normal(N, F, 3), facial=normal(N, F, 100),
             contact=normal(N, F, 4),
             word=normal(N, cc["text_frames"], dc["text_latent_dim"]),
             audio=normal(N, cc["audio_frames"], dc["audio_latent_dim"]),
             speaker_ids=torch.randint(0, dc["num_speakers"], (N,),
                                       generator=g, device=device),
             motion_mask=torch.ones(N, F, device=device))
    return d


def draws(config: dict, req: dict, device) -> dict:
    """A call's stacked draws, (steps, B, ...) each."""
    dc = config["denoiser"]
    k, B = req["rows"].shape
    D = dc["latent_dim"]
    L = dc["max_seq_len"] // dc["frame_chunk_size"]
    g = torch.Generator(device=device).manual_seed(req["draw_seed"])
    eps = {p: torch.randn(k, B, L, D, generator=g, device=device)
           for p in ("upper", "hands", "face", "lowertrans")}
    t = torch.randint(0, config["diffusion_train"]["diffusion_steps"],
                      (k, B), generator=g, device=device)
    noise = torch.randn(k, B, 4 * L + 3, D, generator=g, device=device)
    cm = (torch.randint(0, 100, (k, B, 1, 1), generator=g, device=device)
          % 10 > 0).float()
    return {"enc_eps": eps, "t": t, "noise": noise, "cond_mask": cm}


def batch(data: dict, req: dict, device) -> dict:
    """A call's stacked batch (steps, B, ...), gathered on the card."""
    rows = torch.as_tensor(req["rows"], device=device)
    return {k: v[rows] for k, v in data.items()}


def make_system(config, params, seed, device, spans):
    return systems.TrainingSystem(config, params, seed, device, spans)


def check(config, params, seed, kept, evidence, device):
    return checks.check(config, params, seed, evidence, device)
