"""The traced window's records and their arithmetic: the device's
operations from one ``torch.profiler`` window, and the benchmark's own
spans on the host's clock.

The profiler records the card's activity alone: recording every host
operation as well slowed a host-bound training step by two thirds, which
would have left the traced window unlike the measured one.  The spans
are the host's ``perf_counter_ns`` around the benchmark's calls, moved
onto the device records' clock by an anchor: a short sleep kernel
launched at a known host time, whose start the trace holds.  The
arithmetic over device records is a copy of the port's
``utils/profiling.py`` (``device_records``, ``device_busy_ms``,
``profiled``): the raw records are read once, the window opens with a
sleep kernel because a window can lose its first device record, and busy
time is the union of the operations' intervals (a dependent launch
overlaps the kernel before it).
"""

from __future__ import annotations

import contextlib
import re
import time
from typing import Dict, List, Optional, Tuple

import torch

Record = Tuple[str, int, int]          # (name, start ns, end ns)


def kernel_name(key: str) -> str:
    """A device operation's name without namespace, template and
    arguments."""
    name = re.sub(r"\(anonymous namespace\)::|^void ", "", key)
    return name.split("(")[0].split("<")[0][:64]


class Spans:
    """Named host ranges around the benchmark's calls into the program,
    (name, start ns, end ns) on ``perf_counter_ns``, kept while a trace
    is on; nothing otherwise."""

    def __init__(self):
        self.enabled = False
        self.ranges: List[Record] = []

    def __call__(self, name: str):
        return self._span(name) if self.enabled else contextlib.nullcontext()

    @contextlib.contextmanager
    def _span(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.ranges.append((name, t0, time.perf_counter_ns()))


ANCHOR = "spin_kernel"        # torch.cuda._sleep's kernel


@contextlib.contextmanager
def profiled():
    """torch.profiler over the block, the card's activity alone.  The
    window opens with a sleep kernel (a window may lose its first device
    record), then the anchor: another sleep launched at a host time kept
    as ``prof.anchor_ns``.  Neither counts as work."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        prof.anchor_ns = time.perf_counter_ns()
        torch.cuda._sleep(100)
        torch.cuda.synchronize()
        yield prof


def records(prof, spans: List[Record]) -> Tuple[List[Record], List[Record]]:
    """(device operations, spans), each start-sorted on the device
    records' clock: the card's kernels, copies and memsets without the
    sleeps, and the host's spans moved by the anchor's offset."""
    from torch.autograd import DeviceType

    dev, anchors = [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA or getattr(
                ev, "is_hidden_event", lambda: False)():
            continue
        k = kernel_name(torch._C._demangle(ev.name()))
        if ANCHOR in k:
            anchors.append(ev.start_ns())
        else:
            dev.append((k, ev.start_ns(), ev.end_ns()))
    off = (max(anchors) - prof.anchor_ns) if anchors else 0
    moved = [(n, a + off, b + off) for n, a, b in spans]
    return sorted(dev, key=lambda r: r[1]), sorted(moved, key=lambda r: r[1])


def merged(recs: List[Record], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The union of the records' intervals inside [lo, hi], as disjoint
    start-ordered (start, end) pairs."""
    out: List[List[int]] = []
    for _, a, b in sorted(recs, key=lambda r: r[1]):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_ns(recs: List[Record], lo: int, hi: int) -> int:
    return sum(b - a for a, b in merged(recs, lo, hi))


def device_seconds_by_name(recs: List[Record], names=None
                           ) -> Dict[str, float]:
    """{kernel name: device seconds}, of ``names`` only when given."""
    out: Dict[str, float] = {}
    for n, a, b in recs:
        if names is None or n in names:
            out[n] = out.get(n, 0.0) + (b - a) / 1e9
    return out


def idle_gaps(dev: List[Record], spans: List[Record], lo: int, hi: int
              ) -> Dict[str, float]:
    """Seconds of the window [lo, hi] in which no device operation ran,
    each gap named by the innermost benchmark span that covers its middle
    (``outside`` where none does)."""
    busy = merged(dev, lo, hi)
    gaps, cur = [], lo
    for a, b in busy:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        gaps.append((cur, hi))
    out: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) // 2
        inner: Optional[Record] = None
        for s in spans:
            if s[1] <= mid < s[2] and (inner is None
                                       or s[2] - s[1] < inner[2] - inner[1]):
                inner = s
        name = inner[0] if inner else "outside"
        out[name] = out.get(name, 0.0) + (b - a) / 1e9
    return out
