"""Multimodality: mean pairwise distance over seeded repetitions.

Port of ``tools/evaluate_mm.py`` (the reference's evaluate_mm.py:87-160):
expects result dirs ``<prefix>_rep0 .. <prefix>_rep{n-1}`` from runs of
the serving tool with different ``--seed`` values, and prints one JSON
line ``{"multimodality": ...}``.

    python -m raggesture_tpu_torch.tools.evaluate_mm RESULTS_PREFIX \\
        [--reps 5] [--eval-n 300] [--smplx P] [--device cuda|cpu]

FK runs on the CUDA card unless ``--device`` names another device; without
a card the tool exits non-zero.  ``main(argv)`` returns the value and the
seconds of the run (``load_s``, ``evaluate_s``, and the FK's ``fk_s``).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("prefix", help="results dir prefix (expects _rep0.._repN)")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--eval-n", type=int, default=300)
    p.add_argument("--smplx",
                   default="datasets/assets_deps/smplx_models/smplx/"
                           "SMPLX_NEUTRAL_2020.npz")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    from ..device import resolve_device
    from ..eval.evaluator import multimodality
    from ..utils.logger import get_root_logger
    from .evaluate import build_fk_fn

    dev = resolve_device(args.device)
    logger = get_root_logger()
    roots = [f"{args.prefix}_rep{i}" for i in range(args.reps)]
    missing = [r for r in roots if not os.path.isdir(r)]
    if missing:
        raise SystemExit(f"missing repetition dirs: {missing}")

    t0 = time.perf_counter()
    fk_fn, fk_s = None, [0.0]
    if os.path.exists(args.smplx):
        fk = build_fk_fn(args.smplx, device=dev)

        def fk_fn(*a):
            t = time.perf_counter()
            out = fk(*a)
            fk_s[0] += time.perf_counter() - t
            return out
    else:
        logger.warning("SMPL-X missing — multimodality computed in pose space")
    load_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    mm = multimodality(roots, eval_n=args.eval_n, fk_fn=fk_fn)
    logger.info("multimodality: %.6f", mm)
    print(json.dumps({"multimodality": mm}))
    return {"multimodality": mm,
            "seconds": {"load_s": load_s,
                        "evaluate_s": time.perf_counter() - t0,
                        "fk_s": fk_s[0]}}


if __name__ == "__main__":
    main()
