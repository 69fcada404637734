"""SMPL-X body model: batched linear blend skinning in PyTorch.

Port of ``raggesture_tpu/models/smplx.py``.  The model's constants are
tensors on one explicit device (the card unless the caller names another);
every function is a pure function of a :class:`SmplxModel`.  It serves the
foot contacts of the window cache (``datasets/beatx.py::featurize_clip``)
and evaluation's FK to 55 joints and to face vertices
(``tools/evaluate.py``).

The kinematic chain is composed by depth level: every joint of one level
takes its parent's world transform in one batched 4x4 product, so the
SMPL-X tree (11 levels) costs 11 products per call where the JAX package
scans its 55 joints one at a time.  Each joint's transform is the same
product of the same two matrices as in the scan.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import float32_products, resolve_device
from ..ops.rotations import axis_angle_to_matrix


@dataclasses.dataclass(frozen=True)
class SmplxModel:
    """Model constants as float32 tensors on one device (parents int64)."""

    v_template: torch.Tensor     # (V, 3)
    shapedirs: torch.Tensor      # (V, 3, n_betas)
    exprdirs: torch.Tensor       # (V, 3, n_expr)
    posedirs: torch.Tensor       # (9*(J-1), V*3)
    j_regressor: torch.Tensor    # (J, V)
    parents: torch.Tensor        # (J,), parents[0] == -1
    lbs_weights: torch.Tensor    # (V, J)

    @property
    def num_joints(self) -> int:
        return self.j_regressor.shape[0]

    @property
    def device(self) -> torch.device:
        return self.v_template.device

    @functools.cached_property
    def levels(self) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor,
                                                       torch.Tensor]]]:
        """(roots, [(joints, their parents) for each depth >= 1]): the
        kinematic tree grouped by depth, computed once per model."""
        parents = self.parents.cpu().numpy()
        depth = np.zeros(len(parents), np.int64)
        for j, p in enumerate(parents):
            if p >= j:
                raise ValueError(f"parents are not topologically sorted: "
                                 f"joint {j} has parent {p}")
            depth[j] = 0 if p < 0 else depth[p] + 1

        def on_device(a):
            return torch.as_tensor(a, dtype=torch.long, device=self.device)

        roots = on_device(np.nonzero(depth == 0)[0])
        levels = []
        for d in range(1, int(depth.max()) + 1):
            idx = np.nonzero(depth == d)[0]
            levels.append((on_device(idx), on_device(parents[idx])))
        return roots, levels


def _smplx_model(arrays: dict, device) -> SmplxModel:
    dev = resolve_device(device)
    return SmplxModel(**{
        k: torch.as_tensor(np.asarray(v), device=dev,
                           dtype=torch.long if k == "parents"
                           else torch.float32)
        for k, v in arrays.items()})


def load_smplx(npz_path: str, num_betas: int = 300, num_expr: int = 100,
               device=None) -> SmplxModel:
    """Load SMPLX_NEUTRAL_2020.npz (the standard smplx release layout:
    shapedirs stores betas and expressions concatenated at [..., 300:400];
    posedirs (V, 3, P) or (P, V*3); parents from ``kintree_table``) onto
    ``device`` (default: the card)."""
    d = np.load(npz_path, allow_pickle=True)
    shapedirs = np.asarray(d["shapedirs"], np.float32)
    betas_dirs = shapedirs[..., :num_betas]
    if shapedirs.shape[-1] >= num_betas + num_expr:
        expr_dirs = shapedirs[..., num_betas: num_betas + num_expr]
    else:
        expr_dirs = np.zeros(shapedirs.shape[:2] + (num_expr,), np.float32)
    posedirs = np.asarray(d["posedirs"], np.float32)
    if posedirs.ndim == 3:  # (V, 3, P) -> (P, V*3)
        posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T
    parents = np.asarray(d["kintree_table"], np.int64)
    if parents.ndim == 2:
        parents = parents[0]
    parents = parents.astype(np.int32)
    parents[0] = -1
    return _smplx_model(dict(
        v_template=d["v_template"], shapedirs=betas_dirs,
        exprdirs=expr_dirs, posedirs=posedirs,
        j_regressor=d["J_regressor"], parents=parents,
        lbs_weights=d["weights"]), device)


def load_smplx_faces(npz_path: str) -> np.ndarray:
    """(F, 3) int32 triangle list from the SMPL-X npz (key ``f`` in the
    standard release; ``faces`` accepted too)."""
    d = np.load(npz_path, allow_pickle=True)
    for key in ("f", "faces"):
        if key in d:
            return np.asarray(d[key], np.int32)
    raise KeyError(f"no face array ('f'/'faces') in {npz_path}")


def synthetic_faces(num_joints: int = 4, verts_per_joint: int = 6
                    ) -> np.ndarray:
    """Triangle list matching :func:`synthetic_model`'s vertex layout: a fan
    over each joint's vertex cluster."""
    faces = []
    for j in range(num_joints):
        base = j * verts_per_joint
        for k in range(1, verts_per_joint - 1):
            faces.append([base, base + k, base + k + 1])
    return np.asarray(faces, np.int32)


def synthetic_model(num_joints: int = 4, verts_per_joint: int = 6,
                    seed: int = 0, num_betas: int = 10, num_expr: int = 5,
                    posedirs: bool = False, expr_dirs: bool = False,
                    device=None) -> SmplxModel:
    """A well-formed synthetic rig: a joint chain with vertex clusters
    rigidly attached to each joint, a template of about a metre and blend
    shapes scaled by 0.01.  ``posedirs`` and ``expr_dirs`` ask for random
    pose and expression blend shapes (else zeros).

    The draws are the JAX package's, in its order: with ``expr_dirs`` set
    as its ``num_expr != 5`` sentinel sets it, the arrays equal its
    ``synthetic_model``'s."""
    r = np.random.RandomState(seed)
    J, V = num_joints, num_joints * verts_per_joint
    joints = np.cumsum(r.rand(J, 3).astype(np.float32) * 0.3, axis=0)
    v_template = np.concatenate(
        [joints[j] + r.randn(verts_per_joint, 3).astype(np.float32) * 0.05
         for j in range(J)], axis=0)
    weights = np.zeros((V, J), np.float32)
    j_reg = np.zeros((J, V), np.float32)
    for j in range(J):
        weights[j * verts_per_joint: (j + 1) * verts_per_joint, j] = 1.0
        j_reg[j, j * verts_per_joint: (j + 1) * verts_per_joint] = (
            1.0 / verts_per_joint)
    parents = np.arange(-1, J - 1, dtype=np.int32)
    pd = (r.randn(9 * (J - 1), V * 3).astype(np.float32) * 1e-3 if posedirs
          else np.zeros((9 * (J - 1), V * 3), np.float32))
    shapedirs = r.randn(V, 3, num_betas).astype(np.float32) * 0.01
    exprdirs = (r.randn(V, 3, num_expr).astype(np.float32) * 0.01
                if expr_dirs else np.zeros((V, 3, num_expr), np.float32))
    return _smplx_model(dict(
        v_template=v_template, shapedirs=shapedirs, exprdirs=exprdirs,
        posedirs=pd, j_regressor=j_reg, parents=parents,
        lbs_weights=weights), device)


def _rigid_transform_chain(model: SmplxModel, rot_mats: torch.Tensor,
                           rest_joints: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compose per-joint local rotations along the kinematic tree, one
    batched product per depth level.

    rot_mats: (B, J, 3, 3); rest_joints: (B, J, 3) (per sample: betas).
    Returns (posed_joints (B, J, 3), rel_transforms (B, J, 4, 4))."""
    B, J = rot_mats.shape[:2]
    parents = model.parents
    rel_pos = rest_joints - torch.where(
        (parents < 0)[:, None], 0.0, rest_joints[:, parents.clamp_min(0)])
    local = rot_mats.new_zeros(B, J, 4, 4)
    local[..., :3, :3] = rot_mats
    local[..., :3, 3] = rel_pos
    local[..., 3, 3] = 1.0

    roots, levels = model.levels
    world = torch.empty_like(local)
    world[:, roots] = local[:, roots]
    for idx, par in levels:
        world[:, idx] = world[:, par] @ local[:, idx]

    posed_joints = world[..., :3, 3]
    # relative transforms for skinning: world * inv(rest translation)
    correction = (world[..., :3, :3] @ rest_joints[..., None])[..., 0]
    rel = world.clone()
    rel[..., :3, 3] -= correction
    return posed_joints, rel


def lbs(model: SmplxModel, betas: torch.Tensor, pose_aa: torch.Tensor,
        expression: Optional[torch.Tensor] = None,
        transl: Optional[torch.Tensor] = None,
        return_verts: bool = True
        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Batched SMPL-X forward on the model's device, float32 products (no
    TF32 on a card).

    betas: (B, n_betas); pose_aa: (B, J*3) axis-angle (global orient first);
    expression: (B, n_expr); transl: (B, 3).
    Returns (joints (B, J, 3), vertices (B, V, 3) or None)."""
    with float32_products():
        B = pose_aa.shape[0]
        J = model.num_joints
        v_shaped = model.v_template + torch.einsum(
            "vdk,bk->bvd", model.shapedirs, betas)
        if expression is not None:
            v_shaped = v_shaped + torch.einsum(
                "vdk,bk->bvd", model.exprdirs, expression)
        rest_joints = torch.einsum("jv,bvd->bjd", model.j_regressor, v_shaped)

        rot = axis_angle_to_matrix(pose_aa.reshape(B, J, 3))

        # pose-dependent corrective blendshapes
        if return_verts and model.posedirs.numel():
            eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
            pose_feature = (rot[:, 1:] - eye).reshape(B, -1)
            v_posed = v_shaped + (pose_feature @ model.posedirs).reshape(
                B, -1, 3)
        else:
            v_posed = v_shaped

        posed_joints, rel = _rigid_transform_chain(model, rot, rest_joints)

        verts = None
        if return_verts:
            # the per-vertex transforms (B, V, 4, 4) are materialised: ~200
            # MB at 300 frames and SMPL-X's 10,475 vertices, which the card
            # holds, so the product is not chunked
            V = model.lbs_weights.shape[0]
            T = (model.lbs_weights @ rel.reshape(B, J, 16)).reshape(
                B, V, 4, 4)
            verts = (T[..., :3, :3] @ v_posed[..., None])[..., 0] \
                + T[..., :3, 3]

        if transl is not None:
            posed_joints = posed_joints + transl[:, None, :]
            if verts is not None:
                verts = verts + transl[:, None, :]
    return posed_joints, verts


def foot_contacts(model: SmplxModel, betas, pose_aa, transl,
                  foot_joint_ids=(7, 8, 10, 11), fps: int = 30,
                  threshold: float = 0.01) -> torch.Tensor:
    """Foot-contact bits from ankle/foot joint velocities: vel[t] =
    ||j[t+1] - j[t]||, vel[T-1] = 0 (the last frame is always a contact),
    contact where vel < ``threshold``.

    pose_aa: (T, J*3), transl: (T, 3). Returns (T, len(foot_joint_ids))."""
    joints, _ = lbs(model, betas, pose_aa, transl=transl, return_verts=False)
    fj = joints[:, list(foot_joint_ids)]
    vel = torch.linalg.norm(fj[1:] - fj[:-1], dim=-1)
    vel = torch.cat([vel, torch.zeros_like(vel[:1])], dim=0)
    return (vel < threshold).float()
