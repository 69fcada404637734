"""The port's profiler helpers (``utils/profiling.py``) against the JAX
package's: the union-of-intervals device time and the op table read from
the same intervals written in each framework's trace layout (JAX's
``/device:TPU:0`` "XLA Ops" line, torch's ``kernel``/``gpu_memcpy``/
``gpu_memset`` events), the watchdog's contract, and the helpers on the
CPU (``annotate``'s spans: tests/test_torch_tracing.py).  Exact: both
sides sum the same float64 microseconds.  ~2 s on one worker.
"""

import gzip
import json
import os
import time

import numpy as np
import pytest
import torch

# (name, start µs, duration µs): nested, overlapping, disjoint, a long early
# event outlasting the last-starting one, and repeated names
INTERVALS = [("gemm", 10.0, 5.0), ("gemm", 12.0, 2.0), ("copy", 14.0, 6.0),
             ("softmax", 30.0, 1.5), ("long", 40.0, 50.0),
             ("gemm", 45.0, 3.0), ("memset", 60.0, 0.5)]


def _write_jax_trace(logdir):
    os.makedirs(logdir)
    events = [
        {"ph": "M", "name": "process_name", "pid": 7,
         "args": {"name": "/device:TPU:0"}},
        {"ph": "M", "name": "thread_name", "pid": 7, "tid": 3,
         "args": {"name": "XLA Ops"}},
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": "/host:CPU"}},
        {"ph": "X", "pid": 1, "tid": 1, "name": "host_op", "ts": 0.0,
         "dur": 500.0}]
    events += [{"ph": "X", "pid": 7, "tid": 3, "name": n, "ts": ts, "dur": d,
                "args": {}} for n, ts, d in INTERVALS]
    with gzip.open(os.path.join(logdir, "host.trace.json.gz"), "wt") as f:
        json.dump({"traceEvents": events}, f)


def _write_torch_trace(logdir):
    os.makedirs(logdir)
    cat = {"copy": "gpu_memcpy", "memset": "gpu_memset"}
    events = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0,
               "dur": 500.0, "pid": 1, "tid": 1},
              {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
               "ts": 1.0, "dur": 3.0, "pid": 1, "tid": 1},
              # the window's opening sleep kernel, left out
              {"ph": "X", "cat": "kernel", "name": "spin_kernel(long)",
               "ts": 0.0, "dur": 9.0, "pid": 0, "tid": 7}]
    events += [{"ph": "X", "cat": cat.get(n, "kernel"), "name": n, "ts": ts,
                "dur": d, "pid": 0, "tid": 7} for n, ts, d in INTERVALS]
    with open(os.path.join(logdir, "trace.json"), "w") as f:
        json.dump({"traceEvents": events}, f)


def test_device_time_and_op_table_match_jax(tmp_path):
    from raggesture_tpu.utils import profiling as J

    from raggesture_tpu_torch.utils import profiling as P

    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    _write_jax_trace(jdir)
    _write_torch_trace(pdir)
    want = J.chrome_trace_device_time_ms(jdir)
    assert P.chrome_trace_device_time_ms(pdir) == want
    # 10-20 (three overlapping), 30-31.5, 40-90 (two inside): 61.5 µs busy
    # over 80
    assert np.isclose(want["busy_ms"], 0.0615) and want["n_ops"] == 7
    assert np.isclose(want["span_ms"], 0.08)
    keys = ("name", "dur_ms", "count")
    assert ([{k: r[k] for k in keys} for r in P.chrome_trace_op_table(pdir)]
            == [{k: r[k] for k in keys} for r in J.chrome_trace_op_table(jdir)])
    assert P.chrome_trace_device_time_ms(str(tmp_path / "none")) is None


def test_watchdog_marks_the_profiler_wedged(monkeypatch):
    from raggesture_tpu_torch.utils import profiling as P

    monkeypatch.setattr(P, "_PROFILER_WEDGED", False)
    calls = []
    # on the CPU the trace holds no device operation: None, not wedged
    assert P.traced_device_time_ms(lambda: calls.append(1), iters=2) is None
    assert calls == [1, 1] and not P.profiler_wedged()
    # a run that outlasts the timeout: None, and wedged from then on
    t0 = time.perf_counter()
    assert P.traced_device_time_ms(lambda: time.sleep(0.4), iters=50,
                                   timeout_s=0.2) is None
    assert P.profiler_wedged()
    assert time.perf_counter() - t0 < 5.0
    assert P.traced_device_time_ms(lambda: calls.append(1)) is None
    assert len(calls) == 2        # a wedged profiler runs nothing


def test_trace_annotate_and_debug_nans(tmp_path):
    from raggesture_tpu_torch.utils import profiling as P

    with P.trace(str(tmp_path / "t")):
        with P.annotate("my_region"):
            torch.ones(64).sum()
    with open(tmp_path / "t" / P.TRACE_FILE) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "my_region" in names
    P.enable_debug_nans(True)
    try:
        assert torch.is_anomaly_enabled()
    finally:
        P.enable_debug_nans(False)
    assert not torch.is_anomaly_enabled()
    assert P.kernel_name("void (anonymous namespace)::k<float>(int*)") == "k"


class _Record:
    """A raw profiler record (``torch._C._autograd._KinetoEvent``'s
    accessors)."""

    def __init__(self, name, start_us, dur_us, device, hidden=False):
        self._v = (name, round(start_us * 1e3), round((start_us + dur_us)
                                                      * 1e3), device, hidden)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def is_hidden_event(self):
        return self._v[4]


def test_in_process_helpers_read_the_records_the_trace_file_holds(tmp_path):
    """``device_time_by_kernel``, ``device_busy_ms`` and
    ``instances_by_kernel`` on a profile's raw records give what the
    Chrome-trace parsers read from the same intervals: host records, a
    hidden record and the window's sleep kernel left out, names
    demangled and cut as ``kernel_name`` cuts them."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from raggesture_tpu_torch.utils import profiling as P

    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    recs = ([_Record("aten::mm", 0.0, 500.0, cpu),
             _Record("cudaLaunchKernel", 1.0, 3.0, cpu),
             _Record("void at::cuda::(anonymous namespace)::spin_kernel"
                     "(long)", 0.0, 9.0, cuda),
             _Record("hidden", 0.0, 200.0, cuda, hidden=True)]
            + [_Record(f"void {n}<float>(int*)" if n == "gemm" else n, ts, d,
                       cuda) for n, ts, d in INTERVALS])
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: recs)))
    _write_torch_trace(str(tmp_path / "t"))
    want = P.chrome_trace_device_time_ms(str(tmp_path / "t"))
    table = {r["name"]: r for r in
             P.chrome_trace_op_table(str(tmp_path / "t"))}

    by_kernel, n_ops = P.device_time_by_kernel(prof)
    assert n_ops == want["n_ops"] == len(INTERVALS)
    assert P.device_busy_ms(prof) == pytest.approx(want["busy_ms"], abs=1e-9)
    assert by_kernel == pytest.approx({n: r["dur_ms"]
                                       for n, r in table.items()}, abs=1e-9)
    assert P.instances_by_kernel(prof) == {n: r["count"]
                                           for n, r in table.items()}
