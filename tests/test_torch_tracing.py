"""The port's spans (``utils/profiling.py::annotate``, ``recorded_spans``),
on the CPU.

``annotate`` records nothing and calls nothing outside a profiler window;
inside one it keeps each span's name, times and parent and opens a
``record_function`` range, which ``device_records`` does not count as
device work.  A root span that finds the buffer full starts it anew.  The
training step and the generator record their stages in order, and a window
changes none of their results (bitwise).  ~10 s on one worker.
"""

import json
import threading
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raggesture_tpu_torch.utils import profiling as P


def _window():
    return profile(activities=[ProfilerActivity.CPU])


def _since(first):
    return P.recorded_spans()[first:]


def test_annotate_outside_a_window_records_and_calls_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("called outside a profiler window")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", refuse)
    first = len(P.recorded_spans())
    assert not torch.autograd._profiler_enabled()
    ctx = P.annotate("train.step")
    assert ctx is P.annotate("gen.sample")      # one shared null context
    with ctx:
        with P.annotate("inner"):
            torch.ones(4).sum()
    assert _since(first) == []


def test_annotate_in_a_window_records_names_order_parents_and_trace(tmp_path):
    first = len(P.recorded_spans())
    with P.trace(str(tmp_path / "t")):
        with P.annotate("outer"):
            with P.annotate("a"):
                torch.ones(8).sum()
            with pytest.raises(ValueError):
                with P.annotate("b"):
                    raise ValueError("the span closes on the way out")
        with P.annotate("next"):
            pass
    got = _since(first)
    assert [s[0] for s in got] == ["outer", "a", "b", "next"]
    base = first
    assert [s[3] for s in got] == [-1, base, base, -1]
    for _, a, b, _ in got:
        assert b is not None and a <= b
    outer, a, b, nxt = got
    assert outer[1] <= a[1] <= a[2] <= b[1] <= b[2] <= outer[2] <= nxt[1]
    with open(tmp_path / "t" / P.TRACE_FILE) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"outer", "a", "b", "next"} <= names


def test_annotate_records_in_the_windows_thread_up_to_its_bound(
        monkeypatch):
    """A torch profiler window is its opening thread's: a thread started
    inside it records nothing.  Past ``MAX_SPANS`` nothing more is kept,
    and the spans kept still close with their times."""
    monkeypatch.setattr(P, "_SPANS", [])
    monkeypatch.setattr(P, "MAX_SPANS", 2)

    def other():
        with P.annotate("thread"):
            pass

    with _window():
        with P.annotate("main"):
            t = threading.Thread(target=other)
            t.start()
            t.join(30)
            assert not t.is_alive()
            with P.annotate("child"):
                with P.annotate("over the bound"):
                    with P.annotate("beyond it"):
                        pass
    got = P.recorded_spans()
    assert [(s[0], s[3]) for s in got] == [("main", -1), ("child", 0)]
    assert all(a <= b for _, a, b, _ in got)


def test_a_root_that_finds_the_buffer_full_starts_it_anew(monkeypatch):
    """Past ``MAX_SPANS`` a child span is dropped, and the next root span
    empties the buffer and records, so a later window is kept."""
    monkeypatch.setattr(P, "_SPANS", [])
    monkeypatch.setattr(P, "MAX_SPANS", 2)
    with _window():
        with P.annotate("old"):
            with P.annotate("old child"):
                with P.annotate("dropped"):
                    pass
    with _window():
        with P.annotate("new"):
            with P.annotate("new child"):
                pass
    got = P.recorded_spans()
    assert [(s[0], s[3]) for s in got] == [("new", -1), ("new child", 0)]
    assert all(b is not None and a <= b for _, a, b, _ in got)


class _Raw:
    """A raw profiler record (``_KinetoEvent``'s accessors)."""

    def __init__(self, name, start, end, device, kind):
        self._v = (name, start, end, device, kind)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def activity_type(self):
        return self._v[4]

    def is_hidden_event(self):
        return False

    def is_user_annotation(self):
        return self._v[4] == "user_annotation"


def test_device_records_leave_the_spans_device_copies_out():
    """On the card torch copies each ``record_function`` range onto the
    device's timeline (``gpu_user_annotation``, a CUDA record): a span
    covering a whole step.  ``device_records`` and the readings over it
    count the kernels and the copy alone."""
    from torch.autograd import DeviceType

    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    recs = [_Raw("train.step", 0, 10_000_000, cpu, "user_annotation"),
            _Raw("train.step", 100, 9_000_000, cuda, "gpu_user_annotation"),
            _Raw("gen.sample", 50, 8_000_000, cuda, "gpu_user_annotation"),
            _Raw("void gemm<float>(int*)", 1_000, 2_000_000, cuda, "kernel"),
            _Raw("Memcpy HtoD (Pageable -> Device)", 3_000_000, 3_500_000,
                 cuda, "gpu_memcpy")]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: recs)))
    copy = P.kernel_name("Memcpy HtoD (Pageable -> Device)")
    assert P.device_records(prof) == [("gemm", 1_000, 2_000_000),
                                      (copy, 3_000_000, 3_500_000)]
    assert P.device_busy_ms(prof) == pytest.approx(2.499)
    assert P.instances_by_kernel(prof) == {"gemm": 1, copy: 1}


def _tiny_state(seed=1):
    from raggesture_tpu_torch.datasets.fixtures import tiny_arch_config
    from raggesture_tpu_torch.models.architecture import create_model
    from raggesture_tpu_torch.train.loop import OptimConfig, create_train_state

    model = create_model(tiny_arch_config(), device="cpu", seed=seed)
    return create_train_state(model, OptimConfig(lr=1e-3, total_steps=20,
                                                 grad_clip=1.0))


def test_multi_step_records_its_stages_and_a_window_changes_nothing():
    from raggesture_tpu_torch.datasets.fixtures import tiny_batch
    from raggesture_tpu_torch.train.loop import make_multi_train_step

    batch = tiny_batch(seed=4, batch=2, device="cpu")
    stacked = {k: torch.stack([v] * 3) for k, v in batch.items()}
    runs = []
    for traced in (False, True):
        state = _tiny_state()
        step = make_multi_train_step(
            state.model.cfg.diffusion_train.schedule())
        first = len(P.recorded_spans())
        g = torch.Generator().manual_seed(3)
        if traced:
            with _window():
                logs = step(state, stacked, g)
        else:
            logs = step(state, stacked, g)
        runs.append((logs, state, _since(first)))
    (logs0, s0, none), (logs1, s1, spans) = runs
    assert none == []
    for k in logs0:
        assert torch.equal(logs0[k], logs1[k]), k
    for (n, p), q in zip(s0.model.state_dict().items(),
                         s1.model.state_dict().values()):
        assert torch.equal(p, q), n
    names = [s[0] for s in spans]
    one = ["train.step", "train.forward", "train.encode", "train.backward",
           "train.optimizer"]
    assert names == one * 3
    first = len(P.recorded_spans()) - len(spans)
    for r in range(3):
        step_, fwd, enc, bwd, opt = spans[5 * r:5 * r + 5]
        i = first + 5 * r
        assert step_[3] == -1
        assert (fwd[3], enc[3], bwd[3], opt[3]) == (i, i + 1, i, i)
        assert (step_[1] <= fwd[1] <= enc[1] <= enc[2] <= fwd[2] <= bwd[1]
                <= bwd[2] <= opt[1] <= opt[2] <= step_[2])


@pytest.mark.parametrize("entry", ["sample", "__call__"])
def test_generator_records_prepare_then_pipeline_and_a_window_changes_nothing(
        entry):
    from raggesture_tpu_torch.datasets.fixtures import tiny_batch
    from raggesture_tpu_torch.models.architecture import StagedGenerator

    model = _tiny_state().model
    gen = StagedGenerator(model, model.cfg.diffusion_test.schedule(),
                          graphs=False)
    b = tiny_batch(seed=5, batch=2, device="cpu")
    batch = {k: b[k] for k in ("word", "audio", "speaker_ids",
                               "motion_mask")}
    call = getattr(gen, entry)
    want = call(batch, torch.Generator().manual_seed(7))
    first = len(P.recorded_spans())
    with _window():
        got = call(batch, torch.Generator().manual_seed(7))
    spans = _since(first)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert [(s[0], s[3]) for s in spans] == [
        ("gen.sample", -1), ("gen.prepare", first), ("gen.pipeline", first)]
    root, prep, pipe = spans
    assert root[1] <= prep[1] <= prep[2] <= pipe[1] <= pipe[2] <= root[2]
