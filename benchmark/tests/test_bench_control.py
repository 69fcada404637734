"""The control on the card: the reference put in the program's place with
the decoder layers' products in fp8 (the configuration states bf16 for
them) has to fail the cell's limit, and the program has to pass it.  At a
size a test run holds: the ``sample.b1`` cell at full width, one seed,
eight clips.  The limits were set from ``python3 -m benchmark.control``'s
readings on a dozen seeds and more (PERF.md)."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark.control import sampling_readings
from benchmark.reference.model import quantized_mm

from bench_tiny import ROOT

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda")


def test_the_control_fails_and_the_program_passes(dev):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    mix = json.loads((ROOT / "benchmark/traffic/sample_b1.json").read_text())
    from benchmark.harness.core import find_cell

    r = sampling_readings(find_cell(bench, "sample.b1"), 2**31 + 77, 8, dev,
                 {"control": quantized_mm(torch.float8_e4m3fn)})
    for name, limit in mix["limits"].items():
        assert r["program"][name] <= limit
    assert any(r["control"][n] > lim for n, lim in mix["limits"].items())
