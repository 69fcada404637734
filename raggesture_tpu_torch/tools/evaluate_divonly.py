"""Diversity / L1div / alignment-only evaluation (no FGD model needed).

Port of ``tools/evaluate_divonly.py`` (the reference's evaluate_divonly.py:
evaluate.py's loader with FGD, retrieval MPJPE and the face FK off),
written to ``metrics_divonly.json``.

    python -m raggesture_tpu_torch.tools.evaluate_divonly RESULT_DIR \\
        [--eval-n 300] [--smplx P] [--avg-vel P] [--out P] \\
        [--device cuda|cpu]

FK runs on the CUDA card unless ``--device`` names another device; without
a card the tool exits non-zero.  ``main(argv)`` returns the summary and the
seconds, as ``evaluate.main`` does.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("result_dir")
    p.add_argument("--eval-n", type=int, default=300)
    p.add_argument("--smplx",
                   default="datasets/assets_deps/smplx_models/smplx/"
                           "SMPLX_NEUTRAL_2020.npz")
    p.add_argument("--out", default=None)
    p.add_argument("--avg-vel", default=None,
                   help="per-joint dataset mean-velocity .npy for beat-align "
                        "normalization (reference --avg_vel_path)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    from ..device import resolve_device
    from ..utils.logger import get_root_logger
    from .evaluate import build_evaluator, run_evaluator

    dev = resolve_device(args.device)
    logger = get_root_logger()
    t0 = time.perf_counter()
    ev = build_evaluator(args, dev, logger, fgd=False, mpjpe=False,
                         face=False)
    report = run_evaluator(ev, args.result_dir, time.perf_counter() - t0)
    print(json.dumps(report["summary"], indent=1))
    out = args.out or os.path.join(args.result_dir, "metrics_divonly.json")
    with open(out, "w") as f:
        json.dump(report["summary"], f, indent=1)
    return report


if __name__ == "__main__":
    main()
