"""Full metric suite over saved result directories: the port's evaluation
tool.

Port of ``tools/evaluate.py``: FGD (VAESKConv 240-d latents over 32-frame
6d-pose windows), BeatAlign, L1div, diversity, retrieval-MPJPE, SRGR
(``--srgr``), face L2/LVD in vertex space, printed and written to
``metrics.json`` with the JAX tool's keys.

    python -m raggesture_tpu_torch.tools.evaluate RESULT_DIR [--eval-n 300] \\
        [--fgd-weights AESKConv_240_100.bin] \\
        [--smplx SMPLX_NEUTRAL_2020.npz] [--avg-vel avg_vel.npy] \\
        [--srgr] [--no-fgd] [--out metrics.json] [--device cuda|cpu]

RESULT_DIR holds result directories as the serving tool writes them.  FK to
55 joints, FK to face vertices, the 6d conversion and the FGD embedding run
on the CUDA card unless ``--device`` names another device; without a card
the tool exits non-zero.  The metric arithmetic is host numpy and scipy.
A missing SMPL-X asset or FGD checkpoint is warned about and its metrics
skipped, as in the JAX tool.  ``--fgd-weights`` is a file written by
``train/checkpoint.py::save_params`` from an ``FGDEmbedder``, or the
reference's checkpoint (``AESKConv_240_100.bin``, converted by
``utils/convert_torch.py::convert_fgd``), told apart by its keys.

``main(argv)`` returns the summary, the seconds of the run (the assets'
load, the evaluation, and within it FK, face FK, FGD with the 6d conversion,
and the host metrics: the rest) and the number of each device call.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="evaluate gesture results")
    p.add_argument("result_dir")
    p.add_argument("--eval-n", type=int, default=300)
    p.add_argument("--fgd-weights", default="experiments/fgd/aesconv.pt",
                   help="FGD embedder weights: a save_params file or the "
                        "reference's AESKConv_240_100.bin")
    p.add_argument("--smplx",
                   default="datasets/assets_deps/smplx_models/smplx/"
                           "SMPLX_NEUTRAL_2020.npz")
    p.add_argument("--no-fgd", action="store_true")
    p.add_argument("--avg-vel", default=None,
                   help="per-joint dataset mean-velocity .npy for beat-align "
                        "normalization (reference --avg_vel_path)")
    p.add_argument("--align-mask", type=int, default=10,
                   help="frames trimmed from each end for beat alignment")
    p.add_argument("--srgr", action="store_true")
    p.add_argument("--out", default=None, help="metrics.json path")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def _tensor(x, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32), device=dev)


def build_fk_fn(smplx_path: str, model=None, device=None):
    """FK to the (T, 55, 3) joints on the model's device: ``fk(pose_aa (T,
    165), trans (T, 3), exps (T, 100), betas (300,) or None)``, host arrays
    in and out.  ``betas`` None means zero betas; else the GT betas of
    every frame (the reference FKs with tar_beta, evaluate.py:286)."""
    from ..models.smplx import lbs, load_smplx

    model = model or load_smplx(smplx_path, device=device)
    dev = model.device
    nb = model.shapedirs.shape[-1]
    ne = model.exprdirs.shape[-1]

    @torch.no_grad()
    def fk(pose_aa, trans, exps, betas=None):
        n = pose_aa.shape[0]
        b = (torch.zeros(n, nb, device=dev) if betas is None
             else _tensor(betas, dev)[:nb].expand(n, nb))
        joints, _ = lbs(model, b, _tensor(pose_aa, dev),
                        expression=_tensor(exps, dev)[:, :ne],
                        transl=_tensor(trans, dev), return_verts=False)
        return joints.cpu().numpy()

    return fk


def build_face_fk_fn(smplx_path: str, model=None, jaw_joint: int = 22,
                     device=None):
    """Jaw+expression-only FK to the (T, V*3) vertices for the face L2/LVD
    metrics (reference tools/evaluate.py:329-355: every rotation except
    jaw_pose and every translation zeroed, GT betas and the side's
    expressions active): ``face_fk(pose_aa, exps, betas)``, host arrays in
    and out."""
    from ..models.smplx import lbs, load_smplx

    model = model or load_smplx(smplx_path, device=device)
    dev = model.device
    nb = model.shapedirs.shape[-1]
    ne = model.exprdirs.shape[-1]
    nj = model.num_joints

    @torch.no_grad()
    def face_fk(pose_aa, exps, betas):
        n = pose_aa.shape[0]
        face_pose = torch.zeros(n, nj, 3, device=dev)
        face_pose[:, jaw_joint] = _tensor(pose_aa, dev).reshape(
            n, nj, 3)[:, jaw_joint]
        _, verts = lbs(model, _tensor(betas, dev)[:nb].expand(n, nb),
                       face_pose.reshape(n, nj * 3),
                       expression=_tensor(exps, dev)[:, :ne],
                       transl=None, return_verts=True)
        return verts.reshape(n, -1).cpu().numpy()

    return face_fk


def load_fgd_weights(path: str, model) -> None:
    """Fill ``model`` from a save_params file or from the reference's
    VAESKConv checkpoint, told apart by its keys; any other keys raise."""
    from ..train.checkpoint import load_params
    from ..utils.convert_torch import convert_fgd, load_torch_state

    state = load_torch_state(path)
    if any(k.startswith("encoder.layers.") for k in state):
        convert_fgd(state, model)
    else:
        load_params(path, model)


def build_fgd_fn(weights_path: str, device=None, model=None):
    """The FGD latents of (B, T, 330) 6d poses on ``device`` (default: the
    card): ``embed(poses_6d)``, host arrays in and out."""
    from ..device import resolve_device
    from ..models.eval_fgd import FGDConfig, FGDEmbedder

    dev = resolve_device(device)
    if model is None:
        model = FGDEmbedder(FGDConfig())
        load_fgd_weights(weights_path, model)
    model = model.to(dev).eval()

    @torch.no_grad()
    def embed(poses_6d):
        return model.map2latent(_tensor(poses_6d, dev)).cpu().numpy()

    return embed


def build_evaluator(args: argparse.Namespace, dev, logger, *,
                    fgd: bool = True, mpjpe: bool = True,
                    face: bool = True):
    """The Evaluator of ``args`` on ``dev`` with the assets that exist
    (the others warned about and their metrics skipped)."""
    from ..eval.evaluator import EvalConfig, Evaluator

    fk_fn = face_fk_fn = None
    if os.path.exists(args.smplx):
        from ..models.smplx import load_smplx

        smplx_model = load_smplx(args.smplx, device=dev)
        fk_fn = build_fk_fn(args.smplx, model=smplx_model)
        if face:
            face_fk_fn = build_face_fk_fn(args.smplx, model=smplx_model)
    else:
        logger.warning("SMPL-X asset %s missing — kinematic metrics skipped",
                       args.smplx)
    fgd_fn = None
    if fgd and os.path.exists(args.fgd_weights):
        fgd_fn = build_fgd_fn(args.fgd_weights, device=dev)
    elif fgd:
        logger.warning("FGD weights %s missing — FGD skipped",
                       args.fgd_weights)
    cfg = EvalConfig(eval_n=args.eval_n, compute_fgd=fgd_fn is not None,
                     compute_srgr=getattr(args, "srgr", False),
                     avg_vel_path=args.avg_vel,
                     align_mask=getattr(args, "align_mask", 10),
                     compute_mpjpe=mpjpe)
    return Evaluator(cfg, fgd_embed_fn=fgd_fn, fk_fn=fk_fn,
                     face_fk_fn=face_fk_fn, device=dev)


def run_evaluator(ev, result_dir: str, load_s: float) -> Dict:
    """Evaluate ``result_dir``; the summary and the run's seconds."""
    t0 = time.perf_counter()
    summary = ev.evaluate(result_dir)
    total = time.perf_counter() - t0
    device_s = sum(ev.seconds.values())
    seconds = {"load_s": load_s, "evaluate_s": total,
               **{f"{k}_s": v for k, v in ev.seconds.items()},
               "host_metrics_s": total - device_s}
    return {"summary": summary, "seconds": seconds, "calls": dict(ev.calls)}


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    from ..device import resolve_device
    from ..utils.logger import get_root_logger

    dev = resolve_device(args.device)
    logger = get_root_logger()
    t0 = time.perf_counter()
    ev = build_evaluator(args, dev, logger, fgd=not args.no_fgd)
    report = run_evaluator(ev, args.result_dir, time.perf_counter() - t0)
    print(json.dumps(report["summary"], indent=1))
    out = args.out or os.path.join(args.result_dir, "metrics.json")
    with open(out, "w") as f:
        json.dump(report["summary"], f, indent=1)
    return report


if __name__ == "__main__":
    main()
