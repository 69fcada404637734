"""The readings that a cell's limits are set from: the program's gaps to
the plain reference on many seeds, the control's, and (training) the
faults'.

    python3 -m benchmark.control --workload sample.b32 --seeds 1 2 3 \
        --requests 2
    python3 -m benchmark.control --workload train.b128 --seeds 1 2 3

Each seed in one process, one JSON line a seed.  Sampling: the cell's
set-up, ``--requests`` requests of its mix at its load (the program as the
window runs it), the program freed; then the compared numbers of the
program's clips against the reference (``program``) and of the control,
the reference itself with the decoder layers' products in fp8 (e4m3,
per-tensor scales; the configuration states bf16 for them)
(``control_fp8``), each beside ``bf16``, the reference at the
configuration's own precision, and its ``motion_over_bf16``.  Training: the cell's set-up, whose
first three steps the check reads, against the reference's three steps
(``program``); the control, the program's own bf16 path
(``bf16_compute``, the configuration states float32) (``control_bf16``);
and the faults planted in the program: half of each batch left out, the
mean taken over the rest (``half_batch``), and the denoiser's prediction
altered by 1 % where it is produced (``prediction_altered``).  The first
``--control-seeds`` seeds read the control and the faults.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import json
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]


def _free(device) -> None:
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _served(cell, seed: int, device, requests: int):
    """Set-up and ``requests`` requests of the cell's mix; the evidence
    and the served answers, the program freed."""
    from benchmark.harness.core import generator_module, serve_loop
    from benchmark.harness.trace import Spans

    mod = generator_module(cell.traffic)
    spans = Spans()
    traffic = mod.Traffic(cell.traffic, cell.config, seed)
    system = mod.make_system(cell.config, cell.traffic, seed, device, spans)
    system.warm_up(traffic)
    kept = (serve_loop(system, traffic, spans, 0, count=requests)[3]
            if requests else [])
    evidence = system.evidence()
    system.close()
    del system
    _free(device)
    return evidence, kept


def sampling_readings(cell, seed: int, requests: int, device,
                      variants: dict) -> dict:
    from benchmark.checks import sampling as C

    _, kept = _served(cell, seed, device, requests)
    return {"seed": seed, **C.readings(cell.config, cell.traffic, seed, kept,
                                       device, variants)}


@contextlib.contextmanager
def half_batch():
    """Each step on the first half of its batch: the mean over the rest."""
    from benchmark.systems.training import TrainingSystem

    serve = TrainingSystem.serve

    def halved(self, req):
        req = dict(req, rows=req["rows"][:, :req["rows"].shape[1] // 2])
        return serve(self, req)

    TrainingSystem.serve = halved
    try:
        yield
    finally:
        TrainingSystem.serve = serve


@contextlib.contextmanager
def prediction_altered():
    """The training forward's x0 prediction 1 % larger where produced."""
    from raggesture_tpu_torch.models import architecture as A

    fwd = A.train_denoise_ctx
    A.train_denoise_ctx = lambda *a, **k: fwd(*a, **k) * 1.01
    try:
        yield
    finally:
        A.train_denoise_ctx = fwd


def training_readings(cell, seed: int, device, variants: dict) -> dict:
    from benchmark.checks import training as C

    ref = C.reference(cell.config, cell.traffic, seed, device)
    _free(device)
    out = {"seed": seed}
    for name, (route, patch) in {"program": ({}, None), **variants}.items():
        c = copy.deepcopy(cell)
        c.config["routes"]["training"].update(route)
        with (patch() if patch else contextlib.nullcontext()):
            first, _ = _served(c, seed, device, 0)
        out[name] = C.gaps(first, ref)
        del first
        _free(device)
    return out


def main(argv=None) -> int:
    import torch

    from benchmark.harness.core import find_cell, load_json
    from benchmark.reference.model import quantized_mm

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--control-seeds", type=int, default=3,
                    help="the first this many seeds also read the control")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cell = find_cell(load_json(CHECKOUT / "BENCHMARK.json"), a.workload)
    training = cell.traffic["generator"] == "training"
    if training:
        variants = {"control_bf16": ({"bf16_compute": True}, None),
                    "half_batch": ({}, half_batch),
                    "prediction_altered": ({}, prediction_altered)}
    else:
        variants = {"control_fp8": quantized_mm(torch.float8_e4m3fn)}
    for n, seed in enumerate(a.seeds):
        v = variants if n < a.control_seeds else {}
        r = (training_readings(cell, seed, dev, v) if training else
             sampling_readings(cell, seed, a.requests, dev, v))
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
