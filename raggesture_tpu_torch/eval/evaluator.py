"""Result-directory evaluation: FGD, BeatAlign, L1div, diversity, MPJPE,
SRGR, face metrics.

Port of ``raggesture_tpu/eval/evaluator.py`` (the reference's ``Evaluator``,
tools/evaluate.py:110-464): walks result dirs of ``pred_motion.npz`` /
``gt_motion.npz`` (+ optional ``retrieval_0.npz``, ``gt_audio.wav`` and
``sem_score.npy``), truncates to ``eval_n`` frames @30 fps, converts
axis-angle→6d on the device, embeds each clip's 32-frame-aligned frames
with the FGD model, runs SMPL-X FK to 55 joints and to face vertices for the
kinematic and face metrics, and aggregates.  The FK and FGD callables
(``tools/evaluate.py``) take and return host arrays and run on their
device; the metric arithmetic is host numpy, as in the JAX package.

The evaluator times its device calls (``seconds`` and ``calls``: FK, face
FK, and FGD with its 6d conversion); what is left of a run is host metric
work.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..utils.logger import get_root_logger
from . import metrics as M


@dataclasses.dataclass
class EvalConfig:
    eval_n: int = 300            # frames @30fps (reference --eval_n)
    fgd_window: int = 32
    pose_fps: int = 30
    align_sigma: float = 0.3
    align_order: int = 7
    # frames trimmed from each end of motion/audio for beat alignment
    # (reference align_mask = 10, evaluate.py:134)
    align_mask: int = 10
    # per-joint dataset mean-velocity vector (reference --avg_vel_path,
    # loaded into metric.alignment's mmae normalizer); None = raw speeds
    # with a warning (scores then NOT comparable to the reference's)
    avg_vel_path: Optional[str] = None
    srgr_threshold: float = 0.3
    compute_fgd: bool = True
    compute_mpjpe: bool = True
    compute_srgr: bool = False


# reference tools/evaluate.py:106-108
HAND_JOINTS = list(range(25, 55))
UPPER_BODY_JOINTS = [3, 6, 9, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21]
NOT_UPPERHAND_JOINTS = [i for i in range(55)
                        if i not in UPPER_BODY_JOINTS
                        and i not in HAND_JOINTS]


def find_result_dirs(root: str) -> List[str]:
    """Directories containing a pred_motion.npz (reference iterates
    ``{exp_dir}/*/pred_motion.npz``, tools/evaluate.py:169-181)."""
    return sorted(
        os.path.dirname(p)
        for p in glob.glob(os.path.join(root, "**", "pred_motion.npz"),
                           recursive=True)
    )


def _load_pose(path: str, n: int):
    d = np.load(path, allow_pickle=True)
    poses = np.asarray(d["poses"], np.float32)[:n]
    trans = np.asarray(d["trans"], np.float32)[:n]
    exps = np.asarray(d["expressions"], np.float32)[:n]
    betas = np.asarray(
        d["betas"] if "betas" in d.files else np.zeros(300),
        np.float32).reshape(-1)
    return poses, trans, exps, betas


def pose_aa_to_6d_np(pose_aa: np.ndarray, device) -> np.ndarray:
    """(..., J*3) axis-angle -> (..., J*6) 6d features, converted on
    ``device``."""
    from ..ops.rotations import aa_feature_to_6d

    x = torch.as_tensor(np.asarray(pose_aa, np.float32), device=device)
    return aa_feature_to_6d(x).cpu().numpy()


class Evaluator:
    """Aggregating evaluator over saved result directories."""

    def __init__(self, cfg: EvalConfig = EvalConfig(), fgd_embed_fn=None,
                 fk_fn=None, face_fk_fn=None, device=None):
        """fgd_embed_fn(poses_6d (B,T,330)) -> (B', latent) FGD latents;
        fk_fn(poses_aa (T,165), trans (T,3), exps (T,100), betas (300,) or
        None) -> (T, 55, 3) joints; face_fk_fn(poses_aa (T,165), exps
        (T,100), betas (300,)) -> (T, V*3) vertices of the
        jaw+expression-only body (reference evaluate.py:329-355: all
        body/hand/eye/global rotations and transl zeroed).  Any may be None
        — the dependent metrics are skipped (face metrics fall back to the
        expression-space stand-in).  ``device`` runs the 6d conversion
        (default: the card)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.seconds = {"fk": 0.0, "face_fk": 0.0, "fgd": 0.0}
        self.calls = dict.fromkeys(self.seconds, 0)
        self.fgd_embed_fn = fgd_embed_fn
        self.fk_fn = fk_fn
        self.face_fk_fn = face_fk_fn
        self.logger = get_root_logger()
        self.l1div_pred = M.L1div()
        self.l1div_gt = M.L1div()
        self.mpjpe = M.MPJPE()
        avg_vel = None
        if cfg.avg_vel_path:
            avg_vel = np.load(cfg.avg_vel_path).reshape(-1)
        elif fk_fn is not None:
            self.logger.warning(
                "no avg_vel_path: beat-align velocities are NOT normalized "
                "by the dataset mean-velocity vector (reference "
                "evaluate.py:127-133) — align scores will not be comparable")
        self.align = M.BeatAlignment(sigma=cfg.align_sigma,
                                     order=cfg.align_order,
                                     mean_velocity=avg_vel)
        self.srgr = M.SRGR(threshold=cfg.srgr_threshold)
        self.fgd_pred: List[np.ndarray] = []
        self.fgd_gt: List[np.ndarray] = []
        # reference accumulation (evaluate.py:407-410, 431-464):
        # align += clip_align * (n - 2*align_mask); total_length += n
        self.align_sum = 0.0
        self.align_frames = 0
        # frame-weighted accumulators (reference evaluate.py:366-367,428:
        # l2_all += l2*n; lvel += lvd*n; divided by total_length at the end)
        self.face_l2_sum = 0.0
        self.face_lvd_sum = 0.0
        self.face_frames = 0
        self.face_space = "vertex" if face_fk_fn is not None else "expression"
        self.joints_per_clip: List[np.ndarray] = []

    def _timed(self, key: str, fn, *args) -> np.ndarray:
        t0 = time.perf_counter()
        out = np.asarray(fn(*args))
        self.seconds[key] += time.perf_counter() - t0
        self.calls[key] += 1
        return out

    def _fk_joints(self, pose: np.ndarray, betas: np.ndarray) -> np.ndarray:
        """(T, 55, 3) joints with transl/expressions zeroed and GT betas
        (reference evaluate.py:286-300)."""
        T = len(pose)
        z3 = np.zeros((T, 3), np.float32)
        z100 = np.zeros((T, 100), np.float32)
        return self._timed("fk", self.fk_fn, pose, z3, z100, betas)

    # -- per-clip ------------------------------------------------------------
    def add_result_dir(self, rdir: str):
        n = self.cfg.eval_n
        pred_pose, pred_trans, pred_exps, _ = _load_pose(
            os.path.join(rdir, "pred_motion.npz"), n)
        gt_pose, gt_trans, gt_exps, gt_betas = _load_pose(
            os.path.join(rdir, "gt_motion.npz"), n)
        T = min(len(pred_pose), len(gt_pose))
        pred_pose, gt_pose = pred_pose[:T], gt_pose[:T]

        # FGD latents on 32-frame-aligned 6d pose (evaluate.py:258-275)
        if self.fgd_embed_fn is not None and self.cfg.compute_fgd:
            w = self.cfg.fgd_window
            Tw = T - T % w
            if Tw >= w:
                t0 = time.perf_counter()
                p6 = pose_aa_to_6d_np(pred_pose[:Tw], self.device)
                g6 = pose_aa_to_6d_np(gt_pose[:Tw], self.device)
                self.fgd_pred.append(np.asarray(
                    self.fgd_embed_fn(p6[None])).reshape(-1, 240))
                self.fgd_gt.append(np.asarray(
                    self.fgd_embed_fn(g6[None])).reshape(-1, 240))
                self.seconds["fgd"] += time.perf_counter() - t0
                self.calls["fgd"] += 2

        if self.fk_fn is not None:
            # kinematic joints: the reference FKs with transl and
            # expressions ZEROED and the GT betas (evaluate.py:286-300
            # ``transl=rec_trans-rec_trans, expression=tar_exps-tar_exps,
            # betas=tar_beta``) — root trajectory must not enter
            # L1div/diversity/align/MPJPE
            pj = self._fk_joints(pred_pose, gt_betas)
            gj = self._fk_joints(gt_pose, gt_betas)
            self.l1div_pred.run(pj.reshape(T, -1))
            self.l1div_gt.run(gj.reshape(T, -1))
            self.joints_per_clip.append(pj.reshape(T, -1))

            # retrieval-adherence MPJPE (:240-256, :378-389): first-frame
            # root-normalized joints; mask = frames where the retrieval
            # pose is active AND the joint is upper-body/hand
            retr_path = os.path.join(rdir, "retrieval_0.npz")
            if self.cfg.compute_mpjpe and os.path.exists(retr_path):
                r_pose, r_trans, r_exps, _ = _load_pose(retr_path, n)
                Tr = min(T, len(r_pose))
                if Tr > 0:
                    rj = self._fk_joints(r_pose[:Tr], gt_betas)
                    m3 = np.ones((Tr, 55, 3), np.float32)
                    m3[r_pose[:Tr].reshape(Tr, 55, 3) == 0] = 0
                    m3[:, NOT_UPPERHAND_JOINTS] = 0
                    mask = (m3.sum(-1) > 0).astype(np.float32)  # (Tr, 55)
                    pj_rn = pj[:Tr] - pj[:1, :1]
                    rj_rn = rj - rj[:1, :1]
                    self.mpjpe.compute_error(pj_rn, rj_rn, mask)

            # SRGR on semantic-scored frames (:413-426) — needs the
            # sem_score.npy sidecar written by tools/visualize.py
            sem_path = os.path.join(rdir, "sem_score.npy")
            if self.cfg.compute_srgr and os.path.exists(sem_path):
                sem = np.load(sem_path).reshape(-1)[:T]
                if sem.shape[0] == T:
                    self.srgr.run(pj, gj, sem)

            # beat alignment (:396-410): audio truncated to the motion
            # length and trimmed by align_mask*(sr/fps) on both ends; pose
            # beats from frames [align_mask, T-align_mask); per-clip score
            # weighted by (T - 2*align_mask), denominator total frames
            wav = os.path.join(rdir, "gt_audio.wav")
            am = self.cfg.align_mask
            if os.path.exists(wav) and T > 2 * am:
                from scipy.io import wavfile

                sr, wave = wavfile.read(wav)
                if wave.dtype == np.int16:
                    wave = wave.astype(np.float32) / 32768.0
                if wave.ndim == 2:  # stereo -> mono (librosa.load downmixes)
                    wave = wave.mean(axis=1)
                fps = self.cfg.pose_fps
                wave = wave[: int(sr / fps * T)]
                a_off = int(am * (sr / fps))
                onsets = self.align.audio_beats(
                    wave[a_off: max(len(wave) - a_off, a_off)], sr)
                # motion_beats expects 2D (T, J*3) joints
                beats = self.align.motion_beats(
                    pj.reshape(T, -1), fps, t_start=am, t_end=T - am)
                if len(onsets) and len(beats):
                    score = self.align.calculate_align(onsets, beats, fps)
                    self.align_sum += score * (T - 2 * am)
                    self.align_frames += T

        # face metrics (reference evaluate.py:329-367): FK the
        # jaw+expression-only body to full vertices, MSE + the velocity L1
        # written there as L1(rec[1:]-tar[:-1], tar[1:]-tar[:-1]) — which
        # algebraically equals mean|rec[1:]-tar[1:]| — both frame-weighted.
        if self.face_fk_fn is not None:
            betas = gt_betas
            facial_rec = self._timed("face_fk", self.face_fk_fn, pred_pose,
                                     pred_exps[:T], betas).reshape(T, -1)
            facial_tar = self._timed("face_fk", self.face_fk_fn, gt_pose,
                                     gt_exps[:T], betas).reshape(T, -1)
            fl2 = float(np.mean((facial_rec - facial_tar) ** 2))
            lvd = float(np.mean(np.abs(
                (facial_rec[1:] - facial_tar[:-1])
                - (facial_tar[1:] - facial_tar[:-1]))))
        else:
            # expression-space stand-in (monotonically related for a fixed
            # template) when no SMPL-X asset is available
            fl2 = float(np.mean((pred_exps[:T] - gt_exps[:T]) ** 2))
            pv = np.diff(pred_exps[:T], axis=0)
            gv = np.diff(gt_exps[:T], axis=0)
            lvd = float(np.mean(np.abs(pv - gv)))
        self.face_l2_sum += fl2 * T
        self.face_lvd_sum += lvd * T
        self.face_frames += T

    # -- aggregate -------------------------------------------------------------
    def summarize(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        if self.fgd_pred and self.fgd_gt:
            out["fgd"] = M.frechet_distance(
                np.concatenate(self.fgd_pred), np.concatenate(self.fgd_gt))
        if self.align_frames:
            # reference: sum(per-clip align * (n-2*align_mask)) / total n
            out["align"] = self.align_sum / self.align_frames
        if self.l1div_pred.counter:
            out["l1div"] = self.l1div_pred.avg()
            out["l1div_gt"] = self.l1div_gt.avg()
        if self.mpjpe.total_joints:
            out["mpjpe_retrieval"] = self.mpjpe.get_average_error()
        if self.srgr.counter:
            out["srgr"] = self.srgr.avg()
        if len(self.joints_per_clip) >= 2:
            L = min(j.shape[0] for j in self.joints_per_clip)
            out["diversity"] = M.calculate_avg_distance(
                [j[:L] for j in self.joints_per_clip])
        n = max(self.face_frames, 1)
        out["face_l2"] = self.face_l2_sum / n
        out["face_lvd"] = self.face_lvd_sum / n
        # Python floats: MPJPE of float32 joints is an np.float32, which
        # json refuses (the JAX tool fails there writing metrics.json)
        return {k: float(v) for k, v in out.items()}

    def evaluate(self, root: str) -> Dict[str, float]:
        dirs = find_result_dirs(root)
        if not dirs:
            raise FileNotFoundError(
                f"no result dirs (pred_motion.npz) found under {root!r} — "
                "run raggesture_tpu_torch.tools.visualize first")
        self.logger.info("evaluating %d result dirs under %s", len(dirs), root)
        for d in dirs:
            self.add_result_dir(d)
        summary = self.summarize()
        for k, v in summary.items():
            self.logger.info("%s: %.6f", k, v)
        return summary


def multimodality(roots: List[str], eval_n: int = 300,
                  fk_fn=None) -> float:
    """Mean pairwise joint distance across repetition dirs (reference
    tools/evaluate_mm.py:87-160: 5 seeded reps *_rep0..4), over the result
    names every repetition holds; ``fk_fn`` as the Evaluator's (called
    with betas None)."""
    assert len(roots) >= 2
    per_rep: Dict[str, Dict[str, np.ndarray]] = {}
    names = None
    for root in roots:
        cur = {}
        for d in find_result_dirs(root):
            name = os.path.relpath(d, root)
            pose, trans, exps, _ = _load_pose(
                os.path.join(d, "pred_motion.npz"), eval_n)
            if fk_fn is not None:
                arr = np.asarray(fk_fn(pose, trans, exps, None)).reshape(
                    pose.shape[0], -1)
            else:
                arr = pose
            cur[name] = arr
        per_rep[root] = cur
        names = set(cur) if names is None else names & set(cur)
    names = sorted(names or [])
    dists = []
    for name in names:
        feats = [per_rep[r][name] for r in roots]
        L = min(f.shape[0] for f in feats)
        for i in range(len(feats)):
            for j in range(i + 1, len(feats)):
                dists.append(float(np.linalg.norm(
                    feats[i][:L] - feats[j][:L], axis=-1).mean()))
    return float(np.mean(dists)) if dists else 0.0
