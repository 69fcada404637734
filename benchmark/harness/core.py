"""One run of one cell: the cell's files found by name, the set-up, the
measured window, the traced window, the check of what was served against
the plain reference, the metrics and the result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``).  The mix names its generator
(``traffic/<generator>.py``), which names the adapter that drives the
program (``systems/``) and the check (``checks/``).  Every metric is a
reader of its own (``metrics/<metric>.py``).  So a later cell, mix or
metric is a new file, and no file here changes.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional

ROOT = Path(__file__).resolve().parents[1]          # benchmark/
FORBIDDEN = ("jax", "jaxlib", "flax", "raggesture_tpu")


def process_seconds() -> float:
    """Seconds since this process started (from /proc; where that cannot
    be read, since this module was imported)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def find_cell(bench: dict, name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic and the metrics it reports: those that list it, or list no
    cell at all."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT.parent / cfgs[w["config"]]["file"])
    traffic = load_json(ROOT / "traffic" / f"{w['traffic']}.json")

    def mine(ms):
        return [m for m in ms if name in m.get("workloads", [name])]

    return Cell(name, int(w["chips"]), config, traffic,
                mine(bench["end_to_end"]), mine(bench["per_layer"]))


def load_reader(metric: str):
    """The reader ``metrics/<metric>.py`` (a file name may hold dots)."""
    path = ROOT / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics._{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generator_module(traffic: dict):
    return importlib.import_module(f"benchmark.traffic.{traffic['generator']}")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's, compared as whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


@dataclasses.dataclass
class Request:
    """One request of the window: when it was sent and when its answer was
    on the host (host seconds), its units of work and how many failed."""
    index: int
    sent: float
    done: float
    units: int
    failed: int = 0


@dataclasses.dataclass
class RunRecord:
    """What the readers read: the cell's files, the set-up seconds, the
    measured window's requests, and (traced runs) the traced window's
    device records, spans and work."""
    cell: Cell
    setup_s: float
    window_s: float
    requests: List[Request]
    traced: Optional[dict] = None


def serve_loop(system, traffic, spans, first: int, *,
               seconds: Optional[float] = None,
               count: Optional[int] = None) -> tuple:
    """A closed loop: requests back to back, each sent when the one before
    it has been answered, until ``seconds`` have passed or ``count``
    requests were served.  The window ends when the last answer is in
    (``system.drain`` waits for work still queued), so it holds all the
    work that was sent and all its time."""
    reqs, kept = [], []
    t0 = time.perf_counter()
    i = first
    while True:
        req = traffic.request(i)
        sent = time.perf_counter()
        with spans("request"):
            out = system.serve(req)
        done = time.perf_counter()
        reqs.append(Request(i, sent, done, traffic.units(req)))
        kept.append((req, out))
        i += 1
        if (count is not None and i - first >= count) or (
                seconds is not None and done - t0 >= seconds):
            break
    with spans("drain"):
        system.drain()
    end = time.perf_counter()
    reqs[-1].done = max(reqs[-1].done, end)
    for r, (req, out) in zip(reqs, kept):
        r.failed = system.failed(req, out)
    return t0, end, reqs, kept


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device=None, require_card: bool = True) -> dict:
    """One run; returns the result object (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, maybe ``breakdown``, and
    ``compared`` last)."""
    import torch

    from .trace import Spans

    cell = find_cell(bench, workload)
    if require_card:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: the benchmark runs on the card "
                             "only")
        if torch.cuda.device_count() < cell.chips:
            raise SystemExit(f"{workload} needs {cell.chips} CUDA devices, "
                             f"{torch.cuda.device_count()} found")
        device = torch.device("cuda", 0)
    gen_mod = generator_module(cell.traffic)
    spans = Spans()
    parts = {"start": process_seconds()}
    traffic = gen_mod.Traffic(cell.traffic, cell.config, seed)
    system = gen_mod.make_system(cell.config, cell.traffic, seed, device,
                                 spans)
    parts["system"] = process_seconds()
    system.warm_up(traffic)
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = process_seconds()
    parts["warm_up"] = setup_s

    t0, end, reqs, kept = serve_loop(system, traffic, spans, 0,
                                     seconds=seconds)
    record = RunRecord(cell, setup_s, end - t0, reqs)
    if trace:
        record.traced = traced_window(system, traffic, len(reqs), spans)
        kept += record.traced.pop("kept")

    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        raise SystemExit(3)
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": cell.chips,
                "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                      if device.type == "cuda" else 0)}
    evidence = system.evidence()
    system.close()
    del system
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    compared = gen_mod.check(cell.config, cell.traffic, seed, kept, evidence,
                             device)
    del evidence
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in compared)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_reader(m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if trace:
        dev_info["busy_s"] = record.traced["busy_s"]
        dev_info["window_s"] = record.traced["window_s"]
    limit = power_limit() if device.type == "cuda" else None
    if limit:
        dev_info["name_power_limit"] = limit
    failed = sum(r.failed for r in reqs)
    result = {"correct": correct,
              "attempted": sum(r.units for r in reqs),
              "failed": failed,
              "metrics": metrics,
              "device": dev_info}
    if trace:
        result["breakdown"] = record.traced["breakdown"]
    # set-up's parts: the process's start to the harness (interpreter,
    # torch, the card's context), the system's build, its warm-up
    result["setup_parts"] = {"start_s": parts["start"],
                             "system_s": parts["system"] - parts["start"],
                             "warm_up_s": parts["warm_up"] - parts["system"]}
    result["compared"] = {c["name"]: {"value": c["value"],
                                      "limit": c["limit"]}
                          for c in compared}
    return result


def traced_window(system, traffic, first: int, spans) -> dict:
    """``trace_requests`` more requests of the mix under the profiler, the
    benchmark's spans on: the device records and spans of that window,
    its busy and window seconds, its requests and the breakdown of device
    time and idle gaps."""
    from . import trace as T

    n = int(traffic.params["trace_requests"])
    spans.enabled, spans.ranges = True, []
    try:
        with T.profiled() as prof:
            with spans("window"):
                _, _, reqs, kept = serve_loop(system, traffic, spans, first,
                                              count=n)
    finally:
        spans.enabled = False
    dev, sp = T.records(prof, spans.ranges)
    win = [s for s in sp if s[0] == "window"]
    lo, hi = (win[0][1], win[0][2]) if win else (
        dev[0][1] if dev else 0, dev[-1][2] if dev else 0)
    inside = [r for r in dev if r[2] > lo and r[1] < hi]
    top = sorted(T.device_seconds_by_name(inside).items(),
                 key=lambda kv: -kv[1])[:10]
    gaps = sorted(T.idle_gaps(dev, [s for s in sp if s[0] != "window"],
                              lo, hi).items(), key=lambda kv: -kv[1])[:10]
    return {"device": inside, "spans": sp,
            "busy_s": T.busy_ns(dev, lo, hi) / 1e9,
            "window_s": (hi - lo) / 1e9, "requests": reqs,
            "work": system.work(traffic, [req for req, _ in kept]),
            "breakdown": {"device_ops": [[k, v] for k, v in top],
                          "idle_gaps": [[k, v] for k, v in gaps]},
            "kept": kept}
