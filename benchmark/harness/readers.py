"""Arithmetic shared by the metric readers (``metrics/<name>.py``).  A
reader takes the run's record and returns a number, or None where the run
holds nothing to read (then the metric is left out of the line)."""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from . import peaks


def served_units(run) -> int:
    return sum(r.units - r.failed for r in run.requests)


def rate(run) -> Optional[float]:
    """Units served without failure over the window's seconds."""
    return served_units(run) / run.window_s if run.window_s > 0 else None


def latency_ms(run, q: float) -> Optional[float]:
    """The q-th percentile of every request's ms from sent to answered, a
    failed request counting as never answered."""
    if not run.requests:
        return None
    lat = [(r.done - r.sent) * 1e3 if not r.failed else np.inf
           for r in run.requests]
    return float(np.percentile(lat, q, method="higher"))


def kernel_seconds(run, names: Iterable[str]) -> float:
    names = set(names)
    return sum((b - a) / 1e9 for n, a, b in run.traced["device"]
               if n in names)


def roofline(run, names, calls) -> Optional[float]:
    """% of the named kernels' device time that their roofline bound
    would take: ``calls`` are (FLOPs, bytes, peak FLOP/s) of every call
    the traced window's work holds."""
    if run.traced is None:
        return None
    t = kernel_seconds(run, names)
    if t <= 0:
        return None
    return 100.0 * sum(peaks.bound_s(f, b, p) for f, b, p in calls) / t


def mfu(run, unit_flops: float) -> Optional[float]:
    """% of the card's bf16 peak that the measured window's model FLOPs
    fill: ``unit_flops`` a served unit (a clip, a training sample), over
    the window's seconds.  The measured window, not the traced one: the
    trace's own cost slows the host."""
    if run.traced is None or run.window_s <= 0:
        return None
    return (100.0 * served_units(run) * unit_flops
            / (run.window_s * peaks.MFU_PEAK))


def idle(run) -> Optional[float]:
    """% of the traced window with no device operation running."""
    if run.traced is None or run.traced["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.traced["busy_s"] / run.traced["window_s"])


def sampling_batches(run):
    """The traced window's batches, where the cell samples clips."""
    if run.traced is None or run.traced["work"].get("kind") != "sampling":
        return None
    return run.traced["work"]["batches"]


def training_work(run):
    """The traced window's steps and batch, where the cell trains."""
    if run.traced is None or run.traced["work"].get("kind") != "training":
        return None
    return run.traced["work"]
