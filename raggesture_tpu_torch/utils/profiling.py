"""Tracing and profiling helpers over ``torch.profiler``.

Port of ``raggesture_tpu/utils/profiling.py``: ``trace`` (a Chrome trace of
a block, the card's activity included), ``annotate`` (a named range in the
trace and in NVTX), ``StepTimer``, the trace parsers
(``chrome_trace_device_time_ms``, ``chrome_trace_op_table``),
``traced_device_time_ms`` with its watchdog and ``profiler_wedged``, and
``enable_debug_nans``.  The JAX module's ``xplane_device_time_ms`` reads a
TPU's xplane protobuf and has no counterpart: torch's profiler writes the
Chrome trace only.

Beside them, the in-process helpers that read a profile object rather than
a file (``profiled``, ``device_time_by_kernel``, ``device_busy_ms``,
``instances_by_kernel``, ``device_profile``, ``kernel_name``), which
``chip_smoke.py`` measures every phase with.  On some machines a profiler
window loses its first device record, so ``profiled`` opens each window with
a short sleep kernel that every count and time here leaves out.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import math
import os
import re
import shutil
import tempfile
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

# the Chrome trace categories of device work in torch's profiler output:
# kernels, copies and memsets
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block into ``logdir/trace.json`` (Chrome trace format,
    open with Perfetto or chrome://tracing): the host's operators and, where
    a CUDA card is present, the card's kernels, copies and memsets (the
    window opened by a sleep kernel, as :func:`profiled` does, which the
    parsers here leave out).  Yields the profile."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        if cuda:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range that shows in the profiler's timeline
    (``record_function``) and, on a CUDA card, as an NVTX range."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class StepTimer:
    """Rolling step-time / throughput tracker for the train loop."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: List[float] = []
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self._times.append(dt)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now
        return dt

    @property
    def mean_step_time(self) -> float:
        return sum(self._times) / len(self._times) if self._times else 0.0

    def throughput(self, items_per_step: int) -> float:
        st = self.mean_step_time
        return items_per_step / st if st > 0 else 0.0


def _trace_events(logdir: str) -> Optional[list]:
    """The events of the newest Chrome trace under ``logdir`` (``*.json``
    or ``*.json.gz``), or None."""
    paths = (glob.glob(os.path.join(logdir, "**", "*.json"), recursive=True)
             + glob.glob(os.path.join(logdir, "**", "*.json.gz"),
                         recursive=True))
    if not paths:
        return None
    path = max(paths, key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def _device_events(events: list) -> list:
    """The device operations of a trace's events, without the window's
    opening sleep kernel."""
    return [ev for ev in events
            if ev.get("ph") == "X" and "dur" in ev
            and ev.get("cat") in DEVICE_CATEGORIES
            and "spin_kernel" not in kernel_name(ev.get("name", ""))]


def _device_spans(events: list) -> List[Tuple[float, float]]:
    return sorted((ev["ts"], ev["ts"] + ev["dur"])
                  for ev in _device_events(events))


def union_ms(spans: List[Tuple[float, float]]) -> Tuple[float, float]:
    """(busy, span) of start-sorted (start, end) intervals in µs, as ms:
    busy the length of their union, span the first start to the last
    end."""
    busy_us = 0.0
    cur_s, cur_e = spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    # merged segments are disjoint and start-ordered, so cur_e is the last
    # end (spans[-1][1] would miss a long early event)
    return busy_us / 1e3, (cur_e - spans[0][0]) / 1e3


def chrome_trace_device_time_ms(logdir: str) -> Optional[dict]:
    """The device time of the Chrome trace under ``logdir``:
    ``{"busy_ms", "span_ms", "n_ops"}``.  ``busy_ms`` is the union of the
    device operations' intervals (a programmatic dependent launch overlaps
    the kernel before it, so a sum of durations would count that stretch
    twice), ``span_ms`` the first start to the last end (host stalls show
    there, not in busy).  None without a trace or a device operation (a
    run on the CPU)."""
    events = _trace_events(logdir)
    spans = _device_spans(events or [])
    if not spans:
        return None
    busy, span = union_ms(spans)
    return {"busy_ms": busy, "span_ms": span, "n_ops": len(spans)}


def chrome_trace_op_table(logdir: str) -> Optional[list]:
    """The Chrome trace's device operations summed by name: rows
    ``{"name", "category", "dur_ms", "count"}``, longest total first.  None
    without a trace or a device operation.  (The JAX module's rows also
    carry XLA's op path and cost model, which a CUDA trace does not.)"""
    events = _trace_events(logdir)
    if events is None:
        return None
    table: Dict[str, dict] = {}
    for ev in _device_events(events):
        row = table.setdefault(ev.get("name", "?"), {
            "name": ev.get("name", "?"), "category": ev["cat"],
            "dur_ms": 0.0, "count": 0})
        row["dur_ms"] += ev["dur"] / 1e3
        row["count"] += 1
    if not table:
        return None
    return sorted(table.values(), key=lambda r: -r["dur_ms"])


_PROFILER_WEDGED = False


def profiler_wedged() -> bool:
    """True once a watchdog timeout has marked the profiler wedged for the
    rest of the process: later calls of :func:`traced_device_time_ms`
    return None at once, and a caller can mark rows whose device columns
    are absent for this reason."""
    return _PROFILER_WEDGED


def traced_device_time_ms(run: Callable[[], object], iters: int = 3,
                          timeout_s: float = 120.0) -> Optional[dict]:
    """Trace ``iters`` calls of ``run()`` into a temporary directory and
    return the device time a call (busy, span and operations divided by
    ``iters``, and ``profile_busy_ms``: :func:`device_busy_ms` of the same
    window's profile object, the in-process reading of the same records);
    None on the CPU, when the profiler fails, or on timeout.

    The trace runs in a watchdog thread (the JAX module's contract): a
    trace that does not end within ``timeout_s`` marks the profiler wedged
    for the rest of the process (:func:`profiler_wedged`), tells the thread
    to stop issuing calls, and returns None rather than stalling the
    caller."""
    global _PROFILER_WEDGED
    if _PROFILER_WEDGED:
        return None
    logdir = tempfile.mkdtemp(prefix="devtime_")
    box = {}
    give_up = threading.Event()

    def work():
        try:
            with trace(logdir) as prof:
                for _ in range(iters):
                    if give_up.is_set():
                        break
                    run()
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
            box["stats"] = chrome_trace_device_time_ms(logdir)
            if box["stats"] is not None:
                box["stats"]["profile_busy_ms"] = device_busy_ms(prof)
        except Exception:
            box["stats"] = None

    t = threading.Thread(target=work, daemon=True)
    t.start()
    t.join(timeout_s)
    try:
        if t.is_alive():
            _PROFILER_WEDGED = True
            give_up.set()
            # let a merely slow iteration drain, so it does not run into
            # the caller's next timed section
            t.join(10.0)
            return None
        stats = box.get("stats")
        if stats is None:
            return None
        return {"busy_ms": stats["busy_ms"] / iters,
                "span_ms": stats["span_ms"] / iters,
                "n_ops": stats["n_ops"] // iters,
                "profile_busy_ms": stats["profile_busy_ms"] / iters}
    finally:
        if not t.is_alive():
            shutil.rmtree(logdir, ignore_errors=True)


def enable_debug_nans(enable: bool = True) -> None:
    """Opt-in NaN tracing: ``torch.autograd.set_detect_anomaly``, which the
    reference turns on always (diffusion_architecture.py:22) and which
    slows every step."""
    torch.autograd.set_detect_anomaly(enable)


# -- in-process profiles (``torch.profiler.profile`` objects) ---------------

def kernel_name(key: str) -> str:
    """A device operation's name without namespace, template and
    arguments."""
    name = re.sub(r"\(anonymous namespace\)::|^void ", "", key)
    return name.split("(")[0].split("<")[0][:64]


def device_records(prof) -> List[Tuple[str, int, int]]:
    """``(kernel name, start ns, end ns)`` of each device operation of the
    profile (kernels, copies, memsets), without the window's first kernel
    (:func:`profiled`'s sleep), read once from the profiler's raw records:
    ``prof.events()`` would first build torch's event tree over every host
    and device record, which for a clip's ~10^5 records takes far longer
    on the host than the clip itself."""
    recs = getattr(prof, "_device_records", None)
    if recs is None:
        from torch.autograd import DeviceType

        recs = []
        for ev in prof.profiler.kineto_results.events():
            hidden = getattr(ev, "is_hidden_event", lambda: False)()
            if ev.device_type() != DeviceType.CUDA or hidden:
                continue
            name = kernel_name(torch._C._demangle(ev.name()))
            if "spin_kernel" not in name:
                recs.append((name, ev.start_ns(), ev.end_ns()))
        prof._device_records = recs
    return recs


@contextlib.contextmanager
def profiled(torch_mod=torch):
    """torch.profiler over the block, the card's activity included.  On
    some machines a window loses its first device record, so each window
    starts with a short sleep kernel, finished before the block begins,
    which the helpers here leave out of every count and time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch_mod.cuda._sleep(1000)
        torch_mod.cuda.synchronize()
        yield prof


def device_time_by_kernel(prof):
    """{kernel name: device ms} and the number of device operations."""
    by_kernel = {}
    recs = device_records(prof)
    for name, a, b in recs:
        by_kernel[name] = by_kernel.get(name, 0.0) + (b - a) / 1e6
    return by_kernel, len(recs)


def device_busy_ms(prof) -> float:
    """Device ms during which at least one device operation of the profile
    ran: the union of their intervals.  A sum of kernel times counts twice
    where a programmatic dependent launch starts before the kernel it
    follows ends (its blocks wait for that kernel inside the launch)."""
    busy, end = 0, -math.inf
    for _, a, b in sorted(device_records(prof), key=lambda r: r[1:]):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6


def instances_by_kernel(prof) -> dict:
    """{kernel name: device operations} of a profile."""
    counts = {}
    for name, _, _ in device_records(prof):
        counts[name] = counts.get(name, 0) + 1
    return counts


def device_profile(torch_mod, fn, calls=1):
    """torch.profiler over ``calls`` calls of ``fn``: device ms by kernel,
    the number of device operations, and the profile.  The profiler now and
    then records only part of a window's device operations (or none), so
    windows are taken until two agree on their count (at most four), and
    the fullest is returned.  Every call launches the same operations, so a
    window whose count is not a multiple of ``calls`` has lost some and
    agrees with none."""
    windows = []
    for _ in range(4):
        with profiled(torch_mod) as p:
            for _ in range(calls):
                fn()
            torch_mod.cuda.synchronize()
        by_kernel, device_ops = device_time_by_kernel(p)
        agree = (device_ops and device_ops % calls == 0
                 and any(device_ops == w[1] for w in windows))
        windows.append((by_kernel, device_ops, p))
        if agree:
            break
    by_kernel, device_ops, p = max(windows, key=lambda w: w[1])
    if not device_ops:
        raise AssertionError("torch.profiler recorded no device activity "
                             "in four windows")
    return by_kernel, device_ops, p
