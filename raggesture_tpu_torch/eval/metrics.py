"""Gesture evaluation metrics, host numpy and scipy.

Port of ``raggesture_tpu/eval/metrics.py`` (the reference's
mogen/models/utils/metric.py):
  - L1div (:12-27): mean absolute deviation of features from their mean
  - SRGR (:30-52): semantic-weighted pose recall, threshold 0.3, x 1/0.165
  - BeatAlignment (:54-243): GAHR(sigma) between audio onsets and
    upper-body joint-velocity minima (argrelextrema order=7, velocities
    normalized by a dataset mean-velocity vector, threshold 0.3)
  - FID / Frechet distance (:246-320): classic mu/cov + matrix sqrt
  - diversity (:324-344): mean pairwise L2 between samples
  - MPJPE (:347-400): masked per-joint position error

The audio onsets (librosa.onset.onset_detect's spectral-flux pipeline in
numpy) are ``datasets/beatx.py``'s ``onset_strength`` and
``detect_onsets``, re-exported here.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
from scipy import linalg
from scipy.signal import argrelextrema

from ..datasets.beatx import detect_onsets, onset_strength

__all__ = ["detect_onsets", "onset_strength", "L1div", "SRGR",
           "BeatAlignment", "frechet_distance", "calc_diversity",
           "calculate_avg_distance", "MPJPE"]

# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


class L1div:
    """Mean absolute deviation accumulator (reference :12-27)."""

    def __init__(self):
        self.counter = 0
        self.sum = 0.0

    def run(self, results: np.ndarray):
        results = np.asarray(results, np.float64)
        self.counter += results.shape[0]
        mean = results.mean(axis=0)
        self.sum += np.abs(results - mean).sum()

    def avg(self) -> float:
        return self.sum / max(self.counter, 1)

    def reset(self):
        self.counter, self.sum = 0, 0.0


class SRGR:
    """Semantic-relevant gesture recall (reference :30-52)."""

    def __init__(self, threshold: float = 0.3, joints: int = 55):
        self.threshold = threshold
        self.joints = joints
        self.counter = 0
        self.sum = 0.0

    def run(self, results, targets, semantic) -> float:
        results = np.asarray(results).reshape(-1, self.joints, 3)
        targets = np.asarray(targets).reshape(-1, self.joints, 3)
        semantic = np.asarray(semantic).reshape(-1)
        diff = np.abs(results - targets).sum(axis=2)  # (N, J)
        success = np.where(diff < self.threshold, 1.0, 0.0)
        success *= semantic[:, None] * (1.0 / 0.165)
        rate = success.sum() / (success.shape[0] * success.shape[1])
        self.counter += success.shape[0]
        self.sum += rate * success.shape[0]
        return rate

    def avg(self) -> float:
        return self.sum / max(self.counter, 1)


class BeatAlignment:
    """Audio-onset / motion-beat alignment via GAHR (reference :54-243).

    Motion beats: per-joint velocity local minima (argrelextrema, order) on
    velocities normalized by a mean-velocity vector, masked to velocity >
    threshold; restricted to the upper-body joint subset."""

    UPPER_BODY = [3, 6, 9, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21]

    def __init__(self, sigma: float = 0.3, order: int = 7,
                 mean_velocity: Optional[np.ndarray] = None,
                 upper_body: Optional[Sequence[int]] = None,
                 threshold: float = 0.3):
        self.sigma = sigma
        self.order = order
        self.mmae = mean_velocity
        self.upper_body = list(upper_body) if upper_body is not None else self.UPPER_BODY
        self.threshold = threshold

    def audio_beats(self, wave: np.ndarray, sr: int = 16000) -> np.ndarray:
        return detect_onsets(wave, sr)

    def motion_beats(self, joints: np.ndarray, pose_fps: int,
                     t_start=None, t_end=None) -> List[np.ndarray]:
        """joints: (T, J*3) positions.  Central-difference velocities
        (forward/backward at ends), norm per joint, /mmae, minima."""
        x = np.asarray(joints, np.float64)
        dt = 1.0 / pose_fps
        j = x.T  # (D, T)
        init = (j[:, 1:2] - j[:, :1]) / dt
        mid = (j[:, 2:] - j[:, :-2]) / (2 * dt)
        fin = (j[:, -1:] - j[:, -2:-1]) / dt
        vel = np.concatenate([init, mid, fin], axis=1).T.reshape(x.shape[0], -1, 3)
        vel = np.linalg.norm(vel, axis=2)
        if self.mmae is not None:
            vel = vel / self.mmae
        beats = []
        sl = slice(t_start, t_end)
        for i in range(vel.shape[1]):
            mask = np.where(vel[:, i] > self.threshold)[0]
            minima = argrelextrema(vel[sl, i], np.less, order=self.order)[0]
            beats.append(np.asarray([m for m in minima if m in mask]))
        return beats

    @staticmethod
    def gahr(a: Sequence[float], b: Sequence[float], sigma: float) -> float:
        """Mean over b of exp(-min_a |a-b|^2 / 2 sigma^2) (reference :206-217)."""
        if len(b) == 0:
            return 0.0
        total = 0.0
        for b_each in b:
            l2_min = np.inf
            for a_each in a:
                l2_min = min(l2_min, abs(a_each - b_each))
            total += math.exp(-(l2_min**2) / (2 * sigma**2))
        return total / len(b)

    def calculate_align(self, onset_times: np.ndarray,
                        motion_beat_frames: List[np.ndarray],
                        pose_fps: int = 30) -> float:
        vals = []
        for i, beats in enumerate(motion_beat_frames):
            if i not in self.upper_body:
                continue
            pose_t = np.asarray(beats, np.float64) / pose_fps
            vals.append(self.gahr(pose_t, onset_times, self.sigma))
        return sum(vals) / len(vals) if vals else 0.0


def frechet_distance(samples_a: np.ndarray, samples_b: np.ndarray) -> float:
    """FGD between two latent sets (reference FIDCalculator :246-320)."""
    mu1, mu2 = samples_a.mean(0), samples_b.mean(0)
    s1 = np.cov(samples_a, rowvar=False)
    s2 = np.cov(samples_b, rowvar=False)
    try:
        return _frechet(mu1, s1, mu2, s2)
    except ValueError:
        return 1e10


def _frechet(mu1, sigma1, mu2, sigma2, eps=1e-6):
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    assert mu1.shape == mu2.shape and sigma1.shape == sigma2.shape
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(
                f"Imaginary component {np.max(np.abs(covmean.imag))}"
            )
        covmean = covmean.real
    return float(
        diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
        - 2 * np.trace(covmean)
    )


def calc_diversity(feats: np.ndarray) -> float:
    """Mean pairwise L2 (reference :324-328)."""
    feats = np.asarray(feats)
    n, c = feats.shape
    diff = feats[None] - feats[:, None]
    return float(np.sqrt((diff**2).sum(-1)).sum() / n / (n - 1))


def calculate_avg_distance(feature_list, mean=None, std=None) -> float:
    """Per-sample-length-normalized mean pairwise distance (reference
    :330-344 — used as the 'diversity' metric in tools/evaluate.py)."""
    feats = np.stack(feature_list)
    n = feats.shape[0]
    if mean is not None and std is not None:
        feats = (feats - mean) / std
    dist = 0.0
    for i in range(n):
        for j in range(i + 1, n):
            dist += np.linalg.norm(feats[i] - feats[j]) / feats[j].shape[0]
    return dist / ((n * n - n) / 2)


class MPJPE:
    """Masked mean per-joint position error accumulator (reference :347-400)."""

    def __init__(self):
        self.total_error = 0.0
        self.total_joints = 0

    def compute_error(self, predicted, ground_truth, mask=None) -> float:
        predicted = np.asarray(predicted)
        ground_truth = np.asarray(ground_truth)
        error = np.linalg.norm(predicted - ground_truth, axis=-1)
        if mask is not None:
            error = error * mask
        self.total_error += error.sum()
        self.total_joints += error.size
        return float(error.mean())

    def get_average_error(self) -> float:
        return self.total_error / self.total_joints if self.total_joints else 0.0

    def reset(self):
        self.total_error, self.total_joints = 0.0, 0
