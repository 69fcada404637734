"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload sample.b32 --seed 7 --seconds 10 \
        --trace 0

from the root of a checkout that holds ``BENCHMARK.json``.  The cell's
configuration, traffic and metrics are found by the names there.  The run
builds what the cell needs from the seed, warms up, serves the mix for
``--seconds``, (``--trace 1``) serves a fixed number of further requests
under the profiler, checks what was served against the plain reference,
and prints: on standard error, last, each compared number beside its
limit; on standard output, last, one JSON object with ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (``breakdown`` when
traced) and ``compared``.  Without a CUDA card it exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    # every build and kernel cache stays at a fixed place in the checkout
    cache = CHECKOUT / "benchmark" / "_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    from benchmark.harness.core import load_json, run_cell

    bench = load_json(CHECKOUT / "BENCHMARK.json")
    result = run_cell(bench, a.workload, a.seed, a.seconds, bool(a.trace))
    print(f"correct = {result['correct']}", file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
