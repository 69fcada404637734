"""Sampling traffic: requests for 150-frame clips, each with its own text
and audio features, speaker and start noise, sent in a closed loop, a
batch of clips at a time.

The mix's file gives ``batch`` (clips a request), ``feature_pool`` (the
distinct text and audio feature windows the requests draw from, made from
the seed at set-up), ``features_on`` (``device``: the pools stay on the
card, as a featurizer there would leave them; ``host``: each request's
features are copied from host memory in the timed path),
``trace_requests`` (requests in the traced window), ``check_clips`` (clips
of the window held to the reference) and ``limits`` (of the compared
numbers).  Request ``i`` of seed ``s`` is the same in every run: its pool
rows, speakers and noise seed come from ``SeedSequence([s, i])``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..checks import sampling as checks
from ..systems import sampling as systems


def draw_seed(*keys: int) -> int:
    """A 64-bit seed from ``keys`` (any non-negative ints)."""
    return int(np.random.SeedSequence(list(keys)).generate_state(
        1, np.uint64)[0])


class Traffic:
    def __init__(self, params: dict, config: dict, seed: int):
        self.params = params
        self.seed = int(seed)
        self.batch = int(params["batch"])
        self.pool = int(params["feature_pool"])
        self.speakers = int(config["denoiser"]["num_speakers"])

    def request(self, i: int) -> dict:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, i]))
        B = self.batch
        return {"index": i,
                "word": rng.integers(0, self.pool, B),
                "audio": rng.integers(0, self.pool, B),
                "speaker": rng.integers(0, self.speakers, B),
                "noise_seed": draw_seed(self.seed, i, 1)}

    def warm_up_request(self, j: int) -> dict:
        """Requests that the window never sends (their index is negative
        in the draw)."""
        req = self.request(j)
        req["index"] = -1 - j
        req["noise_seed"] = draw_seed(self.seed, j, 2)
        return req

    def units(self, req: dict) -> int:
        return len(req["speaker"])


def feature_pools(config: dict, params: dict, seed: int, device):
    """The text (P, Nt, 768) and audio (P, Na, 768) feature pools, normal
    draws from the seed on ``device``."""
    c, dc = config["conditions"], config["denoiser"]
    g = torch.Generator(device=device).manual_seed(draw_seed(seed, 0, 3))
    P = int(params["feature_pool"])
    word = torch.randn(P, c["text_frames"], dc["text_latent_dim"],
                       generator=g, device=device)
    audio = torch.randn(P, c["audio_frames"], dc["audio_latent_dim"],
                        generator=g, device=device)
    return word, audio


def start_noise(config: dict, req: dict, device) -> torch.Tensor:
    """A request's start noise (B, T, D) from its noise seed."""
    dc = config["denoiser"]
    T = 4 * (dc["max_seq_len"] // dc["frame_chunk_size"]) + 3
    g = torch.Generator(device=device).manual_seed(req["noise_seed"])
    return torch.randn(len(req["speaker"]), T, dc["latent_dim"],
                       generator=g, device=device)


def make_system(config, params, seed, device, spans):
    return systems.SamplingSystem(config, params, seed, device, spans)


def check(config, params, seed, kept, evidence, device):
    return checks.check(config, params, seed, kept, device)
