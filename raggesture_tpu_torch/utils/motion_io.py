"""Motion result IO: npz schema, fps upsampling in 6d space, cross-fades.

Port of ``raggesture_tpu/utils/motion_io.py`` (host numpy; the rotation
conversions are the port's ``ops/rotations.py``, run on the CPU), after the
reference's output path (tools/visualize.py:209-291 pose reassembly + 6d
15→30 fps interpolation, :458-466 smplx2020 npz schema;
tools/longform_synthesis.py:431-518 6d cross-fade stitching).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

import torch

from ..datasets.joints import assemble_pose
from ..ops.rotations import aa_feature_to_6d, d6_feature_to_aa


def _to_6d(pose_aa) -> np.ndarray:
    """Axis-angle (..., J*3) -> 6d (..., J*6), float32, on the CPU."""
    x = torch.as_tensor(np.asarray(pose_aa, np.float32))
    return aa_feature_to_6d(x).numpy()


def _to_aa(d6) -> np.ndarray:
    """6d (..., J*6) -> axis-angle (..., J*3), float32, on the CPU."""
    x = torch.as_tensor(np.asarray(d6, np.float32))
    return d6_feature_to_aa(x).numpy()


def linear_resample(x: np.ndarray, factor: int) -> np.ndarray:
    """(T, D) → (T*factor, D) linear interpolation with half-sample offsets
    (torch F.interpolate mode='linear', align_corners=False — the exact op
    at visualize.py:278-284)."""
    T = x.shape[0]
    new_T = T * factor
    # output index i samples input coordinate (i + 0.5)/factor - 0.5
    pos = (np.arange(new_T) + 0.5) / factor - 0.5
    lo = np.clip(np.floor(pos).astype(int), 0, T - 1)
    hi = np.clip(lo + 1, 0, T - 1)
    w = np.clip(pos - lo, 0.0, 1.0)[:, None]
    return (1.0 - w) * x[lo] + w * x[hi]


def upsample_pose_aa(pose_aa: np.ndarray, factor: int = 2) -> np.ndarray:
    """Axis-angle (T, J*3) → (T*factor, J*3), interpolated in 6d rotation
    space (visualize.py:265-291: aa→matrix→6d, linear interp, 6d→matrix→aa)."""
    d6 = _to_6d(pose_aa)
    return _to_aa(linear_resample(d6, factor))


def crossfade_pose_aa(prev_tail: np.ndarray, next_head: np.ndarray
                      ) -> np.ndarray:
    """Cross-fade two overlapping axis-angle segments in 6d space with
    linspace weights (longform_synthesis.py:431-518)."""
    if prev_tail.shape != next_head.shape:
        raise ValueError(f"cross-fade of {prev_tail.shape} and "
                         f"{next_head.shape}")
    T = prev_tail.shape[0]
    w = np.linspace(0.0, 1.0, T)[:, None]
    mixed = (1.0 - w) * _to_6d(prev_tail) + w * _to_6d(next_head)
    return _to_aa(mixed)


def crossfade_linear(prev_tail: np.ndarray, next_head: np.ndarray
                     ) -> np.ndarray:
    """Linear-space cross-fade (for transl / expressions)."""
    T = prev_tail.shape[0]
    w = np.linspace(0.0, 1.0, T).reshape((T,) + (1,) * (prev_tail.ndim - 1))
    return (1.0 - w) * prev_tail + w * next_head


def reassemble_full_pose(pred: Dict[str, np.ndarray]) -> np.ndarray:
    """4 body-part predictions → full 165-d axis-angle pose via the joint
    masks (visualize.py:209-213)."""
    upper = np.asarray(pred["pred_upper"])
    frames = upper.shape[-2]
    sq = upper.ndim == 3

    def one(i):
        parts = {
            "upper": np.asarray(pred["pred_upper"])[i],
            "hands": np.asarray(pred["pred_hands"])[i],
            "lower": np.asarray(pred["pred_lower"])[i],
            "face": np.asarray(pred["pred_facepose"])[i],
        }
        return assemble_pose(parts, frames)

    if sq:
        return np.stack([one(i) for i in range(upper.shape[0])])
    parts = {
        "upper": np.asarray(pred["pred_upper"]),
        "hands": np.asarray(pred["pred_hands"]),
        "lower": np.asarray(pred["pred_lower"]),
        "face": np.asarray(pred["pred_facepose"]),
    }
    return assemble_pose(parts, frames)


def save_smplx_npz(path: str, poses: np.ndarray, expressions: np.ndarray,
                   trans: np.ndarray, betas: Optional[np.ndarray] = None,
                   fps: int = 30):
    """smplx2020-schema result file (visualize.py:458-466): betas(300),
    poses (T, 165), expressions (T, 100), trans (T, 3), neutral gender."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(
        path,
        # the smplx2020 schema promises betas(300): pad short arrays (e.g.
        # standard 16-dim betas) with zeros, never write a short vector
        betas=(np.zeros(300) if betas is None else np.concatenate([
            np.asarray(betas, np.float64).reshape(-1)[:300],
            np.zeros(max(0, 300 - np.asarray(betas).reshape(-1).shape[0]))])),
        poses=np.asarray(poses),
        expressions=np.asarray(expressions),
        trans=np.asarray(trans),
        model="smplx2020",
        gender="neutral",
        mocap_frame_rate=fps,
    )


def load_smplx_npz(path: str) -> Dict[str, np.ndarray]:
    data = np.load(path, allow_pickle=True)
    return {k: data[k] for k in data.files}
