"""The program's own spans in the traced window, read by the stage
metrics (``metrics/<stage>_host_ms.*.py``, ``metrics/<stage>_idle_ms.*.py``).

The port records a span (``utils/profiling.py::annotate``) at each stage
boundary while a profiler window is open, which in a benchmark run is the
traced window alone: ``(name, start ns, end ns, parent)`` on
``perf_counter_ns``, read back with ``recorded_spans()``.  A program
without them (no ``recorded_spans``, or nothing recorded) gives None.

The spans are moved onto the device records' clock by the offset the
harness moved its own spans by, recovered from the record: the median,
over the traced requests, of the moved ``request`` span's start minus the
request's ``sent`` (``serve_loop`` takes the two back to back).  Each
device-idle gap of the window is named by the innermost program span that
covers its middle (``harness.trace.idle_gaps``).  Per step divides by the
count of ``train.step`` spans in the window, per request by the count of
``gen.sample`` spans.
"""

from __future__ import annotations

import statistics
from typing import List, Optional, Tuple

from raggesture_tpu_torch.utils import profiling

from benchmark.harness.trace import idle_gaps

# (work kind, root span) of each cell kind
TRAINING = ("training", "train.step")
SAMPLING = ("sampling", "gen.sample")

Span = Tuple[int, str, int, int, int]   # (index, name, start, end, parent)


def recorded() -> list:
    """The program's recorded spans, or [] where it keeps none."""
    read = getattr(profiling, "recorded_spans", None)
    return read() if read is not None else []


def clock_offset(run) -> Optional[int]:
    """ns to add to a host ``perf_counter_ns`` time to place it on the
    device records' clock, or None without traced requests."""
    reqs = sorted(run.traced.get("requests", []), key=lambda r: r.sent)
    starts = [a for n, a, _ in run.traced["spans"] if n == "request"]
    if not reqs or len(starts) != len(reqs):
        return None
    return int(statistics.median(a - round(r.sent * 1e9)
                                 for a, r in zip(starts, reqs)))


def window_spans(run, kind) -> Optional[Tuple[List[Span], int, int, int]]:
    """(the program's spans that start inside the traced window, moved
    onto the device clock; the count of roots; the window's start and
    end), or None where the record is untraced, of another cell kind, or
    holds no root span."""
    work, root = kind
    if run.traced is None or run.traced["work"].get("kind") != work:
        return None
    win = [s for s in run.traced["spans"] if s[0] == "window"]
    off = clock_offset(run)
    if not win or off is None:
        return None
    lo, hi = win[0][1], win[0][2]
    spans = [(i, name, a + off, b + off, parent)
             for i, (name, a, b, parent) in enumerate(recorded())
             if b is not None and lo <= a + off < hi]
    roots = sum(1 for s in spans if s[1] == root)
    return (spans, roots, lo, hi) if roots else None


def host_ms(run, kind, stage: str, without: str = "") -> Optional[float]:
    """Host ms a root spends in ``stage``, less its child spans named
    ``without`` (its self time where those are its only children)."""
    got = window_spans(run, kind)
    if got is None:
        return None
    spans, roots, _, _ = got
    mine = {s[0] for s in spans if s[1] == stage}
    ns = sum(b - a for i, n, a, b, p in spans if i in mine)
    ns -= sum(b - a for i, n, a, b, p in spans if n == without and p in mine)
    return ns / 1e6 / roots


def idle_ms(run, kind, stage: str) -> Optional[float]:
    """Device-idle ms a root whose innermost program span is ``stage``."""
    got = window_spans(run, kind)
    if got is None:
        return None
    spans, roots, lo, hi = got
    gaps = idle_gaps(run.traced["device"], [(n, a, b)
                                            for _, n, a, b, _ in spans],
                     lo, hi)
    return 1e3 * gaps.get(stage, 0.0) / roots
