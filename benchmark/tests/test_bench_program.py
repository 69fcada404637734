"""The readers of the program's spans (``metrics/_program.py`` and the
stage metrics) on synthetic run records, on the CPU: they place the spans
on the device records' clock by the offset they recover from a record, and
divide host and idle time by stage exactly; they read nothing from an
untraced record, from the other cell kind, or where the program recorded
nothing.  On the card (``cuda``): the port's spans record in the harness's
own traced window, and no device record the harness keeps bears a span's
name."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark.harness import trace as T
from benchmark.harness.core import Request, RunRecord, load_reader
from benchmark.metrics import _program
from raggesture_tpu_torch.utils import profiling as P

from bench_tiny import ROOT

TRAIN_METRICS = [f"{s}_{k}_ms.train" for k in ("host", "idle")
                 for s in ("encode", "fwd", "bwd", "opt")]
SAMPLE_METRICS = [f"{s}_{k}_ms.b1" for k in ("host", "idle")
                  for s in ("prepare", "pipeline")]


OFF = 5_000_000_123                 # host ns -> device clock ns
H0 = 1_000_000_000_000              # the host's first ns of the window


def _record(kind, requests, device, traced=True):
    """A run record of ``kind`` whose traced window is host [H0, H0 + 1e6]
    ns: ``requests`` (host sent ns, request span's start offset ns, end
    ns) and ``device`` (start, end) in host ns, both moved by OFF."""
    if not traced:
        return RunRecord(None, 1.0, 1.0, [], None)
    spans = [("window", H0 + OFF, H0 + 1_000_000 + OFF)]
    reqs = []
    for i, (sent, delta, end) in enumerate(requests):
        reqs.append(Request(i, sent / 1e9, end / 1e9, 1))
        spans.append(("request", sent + delta + OFF, end + OFF))
    work = ({"kind": "training", "batch": 1, "steps": 2}
            if kind == "training" else {"kind": "sampling", "batches": [1]})
    return RunRecord(None, 1.0, 1.0, [], {
        "device": [("k", a + OFF, b + OFF) for a, b in device],
        "spans": sorted(spans, key=lambda s: s[1]), "requests": reqs,
        "work": work})


def _busy_but(gaps, lo=H0, hi=H0 + 1_000_000):
    """Device records covering [lo, hi] but the (start, end) ``gaps``."""
    out, cur = [], lo
    for a, b in sorted(gaps):
        out.append((cur, a))
        cur = b
    return out + [(cur, hi)]


def _read(name, run):
    return load_reader(name).read(run)


def _training_case():
    """Two steps, in requests 0 and 1 of three (their request spans start
    0, 700 and -200 ns from ``sent``: median 0), each with known stage
    times and one device-idle gap in each stage and one in the step alone;
    a step before the window and a span left open are not read."""
    recs, gaps = [], []
    reqs = [(H0 + 1_000, 0, H0 + 300_000), (H0 + 300_000, 700, H0 + 600_000),
            (H0 + 600_000, -200, H0 + 900_000)]
    recs.append(("train.step", H0 - 90_000, H0 - 50_000, -1))
    for r in range(2):
        B = reqs[r][0] + 10_000
        i = len(recs)
        recs += [("train.step", B, B + 40_000, -1),
                 ("train.forward", B + 1_000, B + 21_000, i),
                 ("train.encode", B + 2_000, B + 10_000, i + 1),
                 ("train.backward", B + 22_000, B + 32_000, i),
                 ("train.optimizer", B + 33_000, B + 39_000, i)]
        gaps += [(B + 4_000, B + 6_000), (B + 15_000, B + 18_000),
                 (B + 21_000, B + 22_000), (B + 25_000, B + 26_000),
                 (B + 34_000, B + 38_000)]
    recs.append(("train.step", H0 + 700_000, None, -1))
    gaps.append((H0 + 800_000, H0 + 850_000))       # in request 2: outside
    return recs, reqs, gaps


def test_readers_recover_the_offset_and_divide_training_by_stage(
        monkeypatch):
    recs, reqs, gaps = _training_case()
    monkeypatch.setattr(P, "_SPANS", recs)
    run = _record("training", reqs, _busy_but(gaps))
    assert _program.clock_offset(run) == OFF
    want = {"encode_host_ms.train": 0.008, "fwd_host_ms.train": 0.012,
            "bwd_host_ms.train": 0.010, "opt_host_ms.train": 0.006,
            "encode_idle_ms.train": 0.002, "fwd_idle_ms.train": 0.003,
            "bwd_idle_ms.train": 0.001, "opt_idle_ms.train": 0.004}
    got = {m: _read(m, run) for m in TRAIN_METRICS}
    assert got == pytest.approx(want, rel=1e-12)
    spans, roots, lo, hi = _program.window_spans(run, _program.TRAINING)
    assert roots == 2 and len(spans) == 10
    assert (lo, hi) == (H0 + OFF, H0 + 1_000_000 + OFF)


def test_readers_divide_a_sampling_request_by_stage(monkeypatch):
    reqs = [(H0 + 1_000 + 100_000 * r, 0, H0 + 99_000 + 100_000 * r)
            for r in range(4)]
    recs, gaps = [], []
    for r in range(4):
        B = reqs[r][0] + 5_000
        i = len(recs)
        recs += [("gen.sample", B, B + 60_000, -1),
                 ("gen.prepare", B + 1_000, B + 10_000, i),
                 ("gen.pipeline", B + 11_000, B + 59_000, i)]
        gaps += [(B + 2_000, B + 9_000), (B + 12_000, B + 13_000),
                 (B + 20_000 + r * 1_000, B + 21_000 + r * 1_000)]
    monkeypatch.setattr(P, "_SPANS", recs)
    run = _record("sampling", reqs, _busy_but(gaps))
    got = {m: _read(m, run) for m in SAMPLE_METRICS}
    assert got == pytest.approx({
        "prepare_host_ms.b1": 0.009, "pipeline_host_ms.b1": 0.048,
        "prepare_idle_ms.b1": 0.007, "pipeline_idle_ms.b1": 0.002},
        rel=1e-12)


@pytest.mark.parametrize("metric", TRAIN_METRICS + SAMPLE_METRICS)
def test_a_reader_reads_nothing_where_nothing_is_its_own(metric,
                                                         monkeypatch):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = {m["name"]: m for m in bench["per_layer"]}[metric]
    mine = "training" if metric.endswith(".train") else "sampling"
    assert entry["workloads"] == (["train.b128"] if mine == "training"
                                  else ["sample.b1"])
    recs, reqs, gaps = _training_case()
    if mine == "sampling":
        recs = [("gen.sample", a, b, p) if n == "train.step" else
                ("gen.prepare" if n == "train.forward" else "gen.pipeline",
                 a, b, p) for n, a, b, p in recs]
    other = "sampling" if mine == "training" else "training"
    monkeypatch.setattr(P, "_SPANS", recs)
    assert _read(metric, _record(mine, reqs, _busy_but(gaps))) is not None
    assert _read(metric, _record(mine, reqs, [], traced=False)) is None
    assert _read(metric, _record(other, reqs, _busy_but(gaps))) is None
    monkeypatch.setattr(P, "_SPANS", [])
    assert _read(metric, _record(mine, reqs, _busy_but(gaps))) is None
    # a program that keeps no spans (no recorded_spans) reads nothing
    monkeypatch.setattr(P, "_SPANS", recs)
    monkeypatch.delattr(P, "recorded_spans")
    assert _read(metric, _record(mine, reqs, _busy_but(gaps))) is None


@pytest.mark.cuda
def test_spans_record_in_the_traced_window_and_are_no_device_work():
    """Under the harness's traced window (``trace.profiled``: torch.profiler
    over the card's activity alone) ``annotate`` records its spans, and no
    device record the harness keeps (``trace.records``) bears a span's
    name: the ``record_function`` ranges are not counted as device work."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    stages = {"train.step": ("train.forward", "train.encode",
                             "train.backward", "train.optimizer"),
              "gen.sample": ("gen.prepare", "gen.pipeline")}
    x = torch.randn(512, 512, device="cuda")
    first = len(P.recorded_spans())
    with T.profiled() as prof:
        assert torch.autograd._profiler_enabled()
        for root, kids in stages.items():
            with P.annotate(root):
                for k in kids:
                    with P.annotate(k):
                        y = torch.relu(x @ x)
        y.sum().item()
    got = P.recorded_spans()[first:]
    names = [n for root, kids in stages.items() for n in (root,) + kids]
    assert [s[0] for s in got] == names
    assert all(b is not None and a < b for _, a, b, _ in got)
    dev_recs, _ = T.records(prof, [])
    assert len(dev_recs) >= 12
    assert not {n for n, _, _ in dev_recs} & set(names)
