"""SMPL-X joint groups for the four body parts.

The port's own copy of ``raggesture_tpu/datasets/joints.py``: the
reference's joint masks (mogen/datasets/utils/beatx_utils.py:2 —
beat_smplx_joints / _upper / _hands / _lower / _face), index-based instead
of name-dict-based, same memberships.

The 55-joint SMPL-X order: 0 pelvis, 1/2 hips, 3 spine1, 4/5 knees,
6 spine2, 7/8 ankles, 9 spine3, 10/11 feet, 12 neck, 13/14 collars,
15 head, 16/17 shoulders, 18/19 elbows, 20/21 wrists, 22 jaw,
23/24 eyes, 25-39 left hand, 40-54 right hand.
"""

from __future__ import annotations

import numpy as np

NUM_JOINTS = 55
POSE_DIM = NUM_JOINTS * 3  # 165

UPPER_JOINT_IDS = (3, 6, 9, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21)  # 13
HANDS_JOINT_IDS = tuple(range(25, 55))                                # 30
LOWER_JOINT_IDS = (0, 1, 2, 4, 5, 7, 8, 10, 11)                       # 9
FACE_JOINT_IDS = (22,)                                                # jaw

PART_JOINT_IDS = {
    "upper": UPPER_JOINT_IDS,
    "hands": HANDS_JOINT_IDS,
    "lower": LOWER_JOINT_IDS,
    "face": FACE_JOINT_IDS,
}


def joint_dims(joint_ids) -> np.ndarray:
    """Flattened axis-angle dim indices for a joint set."""
    return np.concatenate([np.arange(j * 3, j * 3 + 3) for j in joint_ids])


def part_mask(part: str) -> np.ndarray:
    """(165,) 0/1 mask selecting a part's dims in the full pose vector."""
    m = np.zeros((POSE_DIM,), np.float32)
    m[joint_dims(PART_JOINT_IDS[part])] = 1.0
    return m


def split_pose(pose: np.ndarray) -> dict:
    """(T, 165) full axis-angle pose -> per-part slices
    (reference beatx_dataset.py:426-440)."""
    return {
        part: pose[..., joint_dims(ids)]
        for part, ids in PART_JOINT_IDS.items()
    }


def assemble_pose(parts: dict, frames: int) -> np.ndarray:
    """Per-part axis-angle arrays -> (T, 165) full pose (zeros for eyes),
    the inverse used by tools/visualize.py:209-213."""
    pose = np.zeros((frames, POSE_DIM), np.float32)
    for part, ids in PART_JOINT_IDS.items():
        key = {"face": "facepose"}.get(part, part)
        if key in parts:
            pose[:, joint_dims(ids)] = np.asarray(parts[key])[:frames]
        elif part in parts:
            pose[:, joint_dims(ids)] = np.asarray(parts[part])[:frames]
    return pose
