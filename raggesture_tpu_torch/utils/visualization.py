"""Motion rendering: SMPL-X mesh videos (pyrender EGL, else a tensor
rasterizer on the device) and a skeleton fallback (matplotlib).

Port of ``raggesture_tpu/utils/visualization.py``, after the reference's
mogen/utils/visualization.py: the checkerboard floor (:26-68), the
auto-framing camera from the active (nonzero-pose) frames (:302-337), the
offscreen mesh render with the mesh hidden on inactive frames (:339-440),
GT-vs-pred and pred-vs-retrieval side by side with one shared camera and
floor (:443-573), the active-anchor helper (:267-299), and video writing
with the audio muxed (:71-168).

The vertices come from the port's SMPL-X forward (``models/smplx.py::lbs``)
on the SMPL-X model's device, in chunks of ``batch`` frames (no padding:
nothing is compiled per shape).  Without pyrender the frames are drawn by
``rasterize_mesh``, tensor code on the same device: the JAX module's
flattened per-triangle bounding-box pass, its barycentric test and
perspective-correct depth in float64, and a depth resolve in which each
pixel takes the nearest fragment and, at equal depth, the one of the later
triangle (the JAX module's "paint far to near, nearest last" with a stable
sort).  The winner is chosen by explicit keys (``scatter_reduce`` of the
depth, then of the fragment index), never by the order of repeated writes,
so the frames are the same bits on every run.  The skeleton frames need
matplotlib; ``write_video`` needs ffmpeg (on PATH) or PIL, and raises
naming both where neither is present.
"""

from __future__ import annotations

import math
import os
import shutil
import subprocess
import warnings
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import float32_products, resolve_device
from .logger import get_root_logger

try:  # pragma: no cover - env dependent
    import pyrender  # noqa: F401
    import trimesh  # noqa: F401

    HAS_PYRENDER = True
except ImportError:
    HAS_PYRENDER = False

HAS_FFMPEG = shutil.which("ffmpeg") is not None

# SMPL-X kinematic bones (parent connections of the 55-joint skeleton).
# Joints 22/23/24 are jaw/leye/reye, all three parented to the head (15).
_SMPLX_PARENTS = [
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
    15, 15, 15, 20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,
    21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53,
]

# Panel colors, RGB 0-255 (reference defaults :446-449, :513-516)
GT_COLOR = (180, 54, 54)
PRED_COLOR = (36, 73, 156)
RETR_COLOR = (54, 156, 73)

Array = Union[np.ndarray, torch.Tensor]


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def active_frame_mask(poses: Array, tol: float = 1e-6) -> np.ndarray:
    """Frames where the pose vector has any nonzero entry (reference
    _active_frame_mask :339-347: zero-padded retrieval frames decode to the
    template at the origin and would skew the framing)."""
    poses = _numpy(poses)
    flat = poses.reshape(poses.shape[0], -1)
    return np.any(np.abs(flat) > tol, axis=1)


def active_frame_range(poses: Array) -> slice:
    """The contiguous span of active frames (to trim skeleton videos)."""
    idx = np.where(active_frame_mask(poses))[0]
    if len(idx) == 0:
        return slice(0, _numpy(poses).shape[0])
    return slice(int(idx[0]), int(idx[-1]) + 1)


# ---------------------------------------------------------------------------
# vertices and joints (the port's SMPL-X forward)
# ---------------------------------------------------------------------------

def _lbs_frames(smplx_model, poses, trans, exps, betas, return_verts,
                batch: int = 256):
    """``models.smplx.lbs`` over (T, ...) frames on the model's device in
    chunks of ``batch``: (joints (T, J, 3), vertices (T, V, 3) or None) as
    device tensors."""
    from ..models.smplx import lbs

    dev = smplx_model.device
    T = poses.shape[0]
    nb = smplx_model.shapedirs.shape[-1]
    ne = smplx_model.exprdirs.shape[-1]
    b = np.zeros((T, nb), np.float32)
    if betas is not None:
        b[:] = np.asarray(betas, np.float32).reshape(-1)[:nb]
    e = np.zeros((T, ne), np.float32)
    if exps is not None:
        e[:, : min(ne, exps.shape[1])] = exps[:, :ne]
    t = (np.zeros((T, 3), np.float32) if trans is None
         else np.asarray(trans, np.float32))
    on = lambda a: torch.as_tensor(a, device=dev)
    joints, verts = [], []
    with torch.no_grad():
        for s in range(0, T, batch):
            j, v = lbs(smplx_model, on(b[s:s + batch]), on(poses[s:s + batch]),
                       expression=on(e[s:s + batch]),
                       transl=on(t[s:s + batch]), return_verts=return_verts)
            joints.append(j)
            if return_verts:
                verts.append(v)
    return (torch.cat(joints), torch.cat(verts) if return_verts else None)


def _npz_params(npz_path: str, max_frames: int):
    d = np.load(npz_path, allow_pickle=True)
    poses = np.asarray(d["poses"], np.float32)[:max_frames]
    trans = np.asarray(d["trans"], np.float32)[:max_frames]
    exps = (np.asarray(d["expressions"], np.float32)[:max_frames]
            if "expressions" in d else None)
    betas = np.asarray(d["betas"], np.float32) if "betas" in d else None
    return poses, trans, exps, betas


def _vertices(npz_path: str, smplx_model, max_frames: int = 600,
              batch: int = 256) -> torch.Tensor:
    poses, trans, exps, betas = _npz_params(npz_path, max_frames)
    return _lbs_frames(smplx_model, poses, trans, exps, betas,
                       return_verts=True, batch=batch)[1]


def vertices_from_npz(npz_path: str, smplx_model, max_frames: int = 600,
                      batch: int = 256) -> np.ndarray:
    """(T, V, 3) LBS vertices of a result npz (reference
    _smplx_vertices_from_params :186-227), computed on the SMPL-X model's
    device ``batch`` frames at a time."""
    return _numpy(_vertices(npz_path, smplx_model, max_frames, batch))


def smplx_active_anchor(npz_path: str, smplx_model,
                        max_frames: int = 600) -> np.ndarray:
    """[mean_x, min_y, mean_z] of the active frames' vertices (reference
    smplx_active_anchor :267-299): subtract a retrieval clip's anchor from
    the prediction's and add the difference to the retrieval's translation
    to put both characters in the same place on screen."""
    d = np.load(npz_path, allow_pickle=True)
    verts = vertices_from_npz(npz_path, smplx_model, max_frames)
    mask = active_frame_mask(np.asarray(d["poses"])[:max_frames])
    if mask.any():
        verts = verts[mask]
    return np.array([float(verts[..., 0].mean()), float(verts[..., 1].min()),
                     float(verts[..., 2].mean())], np.float32)


def joints_from_npz(npz_path: str, smplx_model=None, max_frames: int = 600
                    ) -> np.ndarray:
    """(T, 55, 3) joints of a result npz: SMPL-X FK on the model's device
    when a model is given, else a zero-shape FK surrogate (0.12-length bones
    rotated by the pose chain, on the host), enough to see the motion."""
    poses, trans, exps, betas = _npz_params(npz_path, max_frames)
    if smplx_model is not None:
        joints, _ = _lbs_frames(smplx_model, poses, trans, exps, betas,
                                return_verts=False)
        return _numpy(joints)
    from ..ops.rotations import axis_angle_to_matrix

    T = poses.shape[0]
    J = 55
    R = axis_angle_to_matrix(torch.from_numpy(poses.reshape(T, J, 3))
                             ).numpy()                      # (T, J, 3, 3)
    offs = np.zeros((J, 3), np.float32)
    for j in range(1, J):
        offs[j] = [0.0, -0.12 if j < 22 else -0.04, 0.0]
    joints = np.zeros((T, J, 3), np.float32)
    glob = np.zeros((T, J, 3, 3), np.float32)
    for j in range(J):
        p = _SMPLX_PARENTS[j]
        if p < 0:
            glob[:, j] = R[:, j]
            joints[:, j] = trans
        else:
            glob[:, j] = glob[:, p] @ R[:, j]
            joints[:, j] = joints[:, p] + np.einsum(
                "tij,j->ti", glob[:, p], offs[j])
    return joints


# ---------------------------------------------------------------------------
# camera and floor (shared by the pyrender and tensor paths)
# ---------------------------------------------------------------------------

def compute_auto_framing(vertices: Array,
                         active_mask: Optional[np.ndarray] = None,
                         cam_y_offset: float = 0.4
                         ) -> Tuple[np.ndarray, float]:
    """(camera_pose 4x4 cam→world, floor_y) from a vertex sequence, with the
    reference renderer's constants (compute_auto_framing :302-337): the
    floor 2 cm below the lowest active vertex, the eye at the body's
    mid-height + ``cam_y_offset`` and 2 m behind the centroid, pitched -8°
    about x."""
    fv = _numpy(vertices)
    if active_mask is not None and active_mask.any():
        fv = fv[active_mask]
    lo_y, hi_y = float(fv[..., 1].min()), float(fv[..., 1].max())
    floor_y = lo_y - 0.02
    eye = np.array([fv[..., 0].mean(),
                    0.5 * (floor_y + hi_y) + cam_y_offset,
                    fv[..., 2].mean() + 2.0], np.float64)
    pitch = np.deg2rad(-8.0)
    pose = np.eye(4, dtype=np.float32)
    pose[1:3, 1:3] = [[np.cos(pitch), -np.sin(pitch)],
                      [np.sin(pitch), np.cos(pitch)]]
    pose[:3, 3] = eye
    return pose, floor_y


# one quad per tile, fanned into two CCW-up triangles (the reference floor's
# winding)
_TILE_CORNER_XZ = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
_TILE_TRIS = np.array([[0, 2, 1], [0, 3, 2]], np.int32)


def checkerboard_floor(y: float, length: float = 12.0, tile: float = 1.0,
                       color_a=(170, 170, 170), color_b=(120, 120, 120)
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(verts (N,3), faces (M,3), face_colors (M,3) uint8): an n×n
    checkerboard in the y plane, with the reference's tile size and colors
    (create_checkerboard_floor :26-68)."""
    n = max(1, int(length / tile))
    ij = np.stack(np.meshgrid(np.arange(n), np.arange(n), indexing="ij"),
                  axis=-1).reshape(-1, 2)
    corner_xz = (ij[:, None, :] + _TILE_CORNER_XZ) * tile - length * 0.5
    verts = np.concatenate(
        [corner_xz[..., :1],
         np.full((n * n, 4, 1), y, np.float32),
         corner_xz[..., 1:]], axis=-1).astype(np.float32).reshape(-1, 3)
    faces = (np.arange(n * n, dtype=np.int32)[:, None, None] * 4
             + _TILE_TRIS).reshape(-1, 3)
    even = (ij.sum(axis=1) % 2 == 0)
    tile_rgb = np.where(even[:, None], np.asarray(color_a, np.uint8),
                        np.asarray(color_b, np.uint8))
    return verts, faces, np.repeat(tile_rgb, 2, axis=0).astype(np.uint8)


# ---------------------------------------------------------------------------
# the tensor rasterizer (z-buffer, Lambert shading)
# ---------------------------------------------------------------------------

def _device_of(device, *arrays) -> torch.device:
    if device is not None:
        return torch.device(device)
    for a in arrays:
        if isinstance(a, torch.Tensor):
            return a.device
    return resolve_device(None)


def _rasterize(verts: torch.Tensor, tri: torch.Tensor,
               face_colors: torch.Tensor, camera_pose: torch.Tensor,
               width: int, height: int, yfov: float, bg: torch.Tensor,
               light_dir: Sequence[float]) -> torch.Tensor:
    """One (H, W, 3) uint8 frame on the inputs' device; see
    :func:`rasterize_mesh`.  The screen coordinates, barycentrics and
    depths are float64, the camera transform and shading float32, as the
    JAX module's numpy promotes them."""
    dev = verts.device
    R, t = camera_pose[:3, :3], camera_pose[:3, 3]
    vc = (verts - t) @ R                                # world → camera
    f = 0.5 * height / math.tan(0.5 * yfov)
    z = torch.clamp(-vc[:, 2], min=1e-6).double()
    sx = 0.5 * width + f * vc[:, 0].double() / z
    sy = 0.5 * height - f * vc[:, 1].double() / z

    # two-sided Lambert shading per face (world-space normals)
    v0, v1, v2 = verts[tri[:, 0]], verts[tri[:, 1]], verts[tri[:, 2]]
    n = torch.linalg.cross(v1 - v0, v2 - v0)
    n = n / torch.clamp(torch.sqrt((n * n).sum(1, keepdim=True)), min=1e-12)
    ld = torch.tensor(light_dir, dtype=torch.float32, device=dev)
    ld = ld / torch.sqrt((ld * ld).sum())
    shade = torch.clamp(0.35 + 0.65 * (n @ ld).abs(), 0.0, 1.0)
    shaded = (face_colors.float() * shade[:, None]).to(torch.uint8)

    # every pixel of each visible triangle's bounding box, flattened
    infront = (-vc[:, 2] > 0.05)[tri].all(dim=1)
    tx, ty = sx[tri], sy[tri]
    x0 = torch.clamp(torch.floor(tx.min(1).values), 0, width - 1).long()
    x1 = torch.clamp(torch.ceil(tx.max(1).values), 0, width - 1).long()
    y0 = torch.clamp(torch.floor(ty.min(1).values), 0, height - 1).long()
    y1 = torch.clamp(torch.ceil(ty.max(1).values), 0, height - 1).long()
    w = torch.where(infront, x1 - x0 + 1, 0)
    h = torch.where(infront, y1 - y0 + 1, 0)
    area = w * h
    img = bg.expand(height * width, 3).clone()
    tri_idx = torch.nonzero(area > 0)[:, 0]
    if tri_idx.numel() == 0:
        return img.reshape(height, width, 3)
    area_k = area[tri_idx]
    owner = torch.repeat_interleave(
        torch.arange(tri_idx.numel(), device=dev), area_k)
    starts = torch.cumsum(area_k, 0) - area_k
    local = torch.arange(owner.numel(), device=dev) - starts[owner]
    tid = tri_idx[owner]
    px = x0[tid] + local % w[tid]
    py = y0[tid] + local // w[tid]

    ax, ay = tx[tid, 0], ty[tid, 0]
    bx, by = tx[tid, 1], ty[tid, 1]
    cx, cy = tx[tid, 2], ty[tid, 2]
    fx, fy = px + 0.5, py + 0.5
    d = (bx - ax) * (cy - ay) - (cx - ax) * (by - ay)
    w0 = (bx - fx) * (cy - fy) - (cx - fx) * (by - fy)
    w1 = (cx - fx) * (ay - fy) - (ax - fx) * (cy - fy)
    w2 = d - w0 - w1
    nondeg = d.abs() > 1e-9
    inside = nondeg & (((w0 >= 0) & (w1 >= 0) & (w2 >= 0))
                       | ((w0 <= 0) & (w1 <= 0) & (w2 <= 0)))
    dsafe = torch.where(nondeg, d, torch.ones_like(d))
    zt = z[tri[tid]]
    # perspective-correct depth: interpolate 1/z
    iz = (w0 / dsafe / zt[:, 0] + w1 / dsafe / zt[:, 1]
          + w2 / dsafe / zt[:, 2])
    depth = 1.0 / torch.clamp(iz, min=1e-9)

    pix = (py * width + px)[inside]
    dep = depth[inside]
    col = shaded[tid[inside]]
    # the nearest fragment of each pixel; at equal depth the later one
    zmin = torch.full((height * width,), math.inf, dtype=dep.dtype,
                      device=dev).scatter_reduce(0, pix, dep, "amin")
    near = dep == zmin[pix]
    order = torch.arange(pix.numel(), device=dev)
    best = torch.full((height * width,), -1, dtype=torch.long, device=dev
                      ).scatter_reduce(0, pix[near], order[near], "amax")
    hit = torch.nonzero(best >= 0)[:, 0]
    img[hit] = col[best[hit]]
    return img.reshape(height, width, 3)


def rasterize_mesh(verts: Array, faces: Array, face_colors: Array,
                   camera_pose: Array, width: int, height: int,
                   yfov: float = np.pi / 3.0, bg=(191, 191, 191),
                   light_dir=(0.3, -0.8, -0.5), device=None) -> np.ndarray:
    """One frame: z-buffered perspective rasterization on ``device``
    (default: the device of a tensor input, else the card), with no
    per-pixel Python loop.

    verts: (V, 3) world;  faces: (F, 3);  face_colors: (F, 3) uint8 base
    colors (two-sided Lambert-shaded);  camera_pose: 4x4 cam→world, OpenGL
    convention (the camera looks along -Z).  Returns (H, W, 3) uint8."""
    dev = _device_of(device, verts, faces, face_colors, camera_pose)
    with float32_products():
        img = _rasterize(
            torch.as_tensor(verts, dtype=torch.float32, device=dev),
            torch.as_tensor(faces, device=dev).long(),
            torch.as_tensor(face_colors, dtype=torch.uint8, device=dev),
            torch.as_tensor(camera_pose, dtype=torch.float32, device=dev),
            width, height, yfov,
            torch.tensor(bg, dtype=torch.uint8, device=dev), light_dir)
    return _numpy(img)


def software_mesh_frames(verts_seq: Array, faces: Array, active: np.ndarray,
                         camera_pose: Array, floor_y: float, width: int,
                         height: int, mesh_color=PRED_COLOR, device=None
                         ) -> List[np.ndarray]:
    """A vertex sequence over the checkerboard floor, one frame at a time on
    ``device`` (default: that of ``verts_seq`` when it is a tensor, else
    the card); the mesh is hidden on inactive frames, as in the reference's
    render loop (:412-433)."""
    dev = _device_of(device, verts_seq)
    fverts, ffaces, fcolors = checkerboard_floor(floor_y)
    on = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)
    fv = on(fverts, torch.float32)
    ff = on(ffaces, torch.long)
    fc = on(fcolors, torch.uint8)
    mf = on(np.asarray(faces), torch.long) + fv.shape[0]
    mc = on(np.asarray(mesh_color, np.uint8), torch.uint8).expand(
        mf.shape[0], 3)
    af, ac = torch.cat([ff, mf]), torch.cat([fc, mc])
    seq = on(verts_seq, torch.float32)
    cam = on(camera_pose, torch.float32)
    bg = torch.tensor((191, 191, 191), dtype=torch.uint8, device=dev)
    frames = []
    with float32_products():
        for ti in range(seq.shape[0]):
            if bool(active[ti]):
                img = _rasterize(torch.cat([fv, seq[ti]]), af, ac, cam,
                                 width, height, np.pi / 3.0, bg,
                                 (0.3, -0.8, -0.5))
            else:
                img = _rasterize(fv, ff, fc, cam, width, height, np.pi / 3.0,
                                 bg, (0.3, -0.8, -0.5))
            frames.append(img)
    return [_numpy(f) for f in frames]


def _pyrender_mesh_frames(verts_seq, faces, active, camera_pose, floor_y,
                          width, height, mesh_color=PRED_COLOR
                          ) -> List[np.ndarray]:  # pragma: no cover
    """EGL offscreen pyrender path (reference render_smplx_debug_video
    :339-440): gray background, ambient + key/fill directional lights,
    trimesh checkerboard floor, smooth-shaded mesh re-added per frame and
    hidden on inactive frames."""
    os.environ.setdefault("PYOPENGL_PLATFORM", "egl")
    import pyrender
    import trimesh

    verts_seq = _numpy(verts_seq)
    camera_pose = _numpy(camera_pose)
    scene = pyrender.Scene(bg_color=np.array([0.75, 0.75, 0.75, 1.0]),
                           ambient_light=np.array([0.35, 0.35, 0.35]))
    fverts, ffaces, fcolors = checkerboard_floor(floor_y)
    floor = trimesh.Trimesh(vertices=fverts, faces=ffaces,
                            face_colors=np.concatenate(
                                [fcolors, np.full((len(fcolors), 1), 255,
                                                  np.uint8)], 1),
                            process=False)
    scene.add(pyrender.Mesh.from_trimesh(floor, smooth=False))
    camera = pyrender.PerspectiveCamera(
        yfov=np.pi / 3.0, aspectRatio=float(width) / float(height))
    scene.add(camera, pose=camera_pose.astype(np.float64))
    key = pyrender.DirectionalLight(color=np.ones(3), intensity=3.0)
    fill = pyrender.DirectionalLight(color=np.ones(3), intensity=1.5)
    scene.add(key, pose=camera_pose.astype(np.float64))
    fill_pose = camera_pose.astype(np.float64).copy()
    fill_pose[0, 3], fill_pose[1, 3] = 1.5, 2.0
    scene.add(fill, pose=fill_pose)

    renderer = pyrender.OffscreenRenderer(width, height)
    rgba = np.concatenate(
        [np.asarray(mesh_color, np.uint8), [255]]).astype(np.uint8)
    frames = []
    try:
        for ti in range(verts_seq.shape[0]):
            node = None
            if bool(active[ti]):
                mesh = trimesh.Trimesh(vertices=verts_seq[ti], faces=faces,
                                       process=False)
                mesh.visual.vertex_colors = np.tile(
                    rgba, (mesh.vertices.shape[0], 1))
                node = scene.add(pyrender.Mesh.from_trimesh(mesh, smooth=True))
            color, _ = renderer.render(scene)
            frames.append(np.asarray(color, np.uint8))
            if node is not None:
                scene.remove_node(node)
    finally:
        renderer.delete()
    return frames


def mesh_frames(verts_seq: Array, faces: Array, active: np.ndarray,
                camera_pose: Array, floor_y: float, width: int = 320,
                height: int = 480, mesh_color=PRED_COLOR, device=None
                ) -> List[np.ndarray]:
    """Dispatch: pyrender EGL when installed, else the tensor rasterizer on
    ``device`` (see :func:`software_mesh_frames`)."""
    if HAS_PYRENDER:
        try:
            return _pyrender_mesh_frames(verts_seq, faces, active,
                                         camera_pose, floor_y, width, height,
                                         mesh_color=mesh_color)
        except Exception as e:  # pyrender installed but EGL unusable
            # OffscreenRenderer raises at context creation on headless hosts
            # without an EGL device: fall back, don't crash the tool
            warnings.warn(f"pyrender EGL rendering failed ({e!r}); "
                          "falling back to the software rasterizer")
    return software_mesh_frames(verts_seq, faces, active, camera_pose,
                                floor_y, width, height,
                                mesh_color=mesh_color, device=device)


# ---------------------------------------------------------------------------
# skeleton fallback and the writer
# ---------------------------------------------------------------------------

def skeleton_frames(joints_list: List[np.ndarray], titles: List[str],
                    width: int = 640, height: int = 480) -> List[np.ndarray]:
    """Render (T, 55, 3) joint sequences side by side to RGB frames (needs
    matplotlib)."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("skeleton_frames needs matplotlib, which is not "
                          "installed; give an SMPL-X asset for the mesh "
                          "render instead") from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(joints_list)
    T = min(j.shape[0] for j in joints_list)
    allj = np.concatenate([j[:T] for j in joints_list], axis=0)
    lo, hi = allj.reshape(-1, 3).min(0), allj.reshape(-1, 3).max(0)
    pad = 0.2 * max((hi - lo).max(), 0.5)
    frames = []
    fig, axes = plt.subplots(1, n, figsize=(width / 100 * n, height / 100),
                             dpi=100)
    if n == 1:
        axes = [axes]
    for t in range(T):
        for ax, joints, title in zip(axes, joints_list, titles):
            ax.clear()
            j = joints[t]
            for c, p in enumerate(_SMPLX_PARENTS):
                if p >= 0:
                    ax.plot([j[p, 0], j[c, 0]], [j[p, 1], j[c, 1]],
                            "b-", lw=1)
            ax.scatter(j[:, 0], j[:, 1], s=2, c="r")
            ax.set_xlim(lo[0] - pad, hi[0] + pad)
            ax.set_ylim(lo[1] - pad, hi[1] + pad)
            ax.set_aspect("equal")
            ax.set_title(title, fontsize=8)
            ax.axis("off")
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
        frames.append(buf.copy())
    plt.close(fig)
    return frames


def _has_pil() -> bool:
    try:
        import PIL.Image  # noqa: F401
    except ImportError:
        return False
    return True


def write_video(frames: List[np.ndarray], out_path: str, fps: int = 30,
                audio_path: Optional[str] = None) -> str:
    """frames → mp4 through ffmpeg when it is on PATH (the frames piped in
    raw, the audio muxed, reference :71-168), else an animated GIF through
    PIL.  Raises RuntimeError naming both where neither is available."""
    logger = get_root_logger()
    if not HAS_FFMPEG and not _has_pil():
        raise RuntimeError(
            "write_video needs ffmpeg (on PATH) or PIL (Pillow) to write "
            f"{out_path}; neither is available")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    if HAS_FFMPEG:
        h, w = frames[0].shape[:2]
        cmd = ["ffmpeg", "-y", "-f", "rawvideo", "-pix_fmt", "rgb24",
               "-s", f"{w}x{h}", "-framerate", str(fps), "-i", "-"]
        if audio_path and os.path.exists(audio_path):
            cmd += ["-i", audio_path, "-c:a", "aac", "-shortest"]
        cmd += ["-c:v", "libx264", "-pix_fmt", "yuv420p", out_path]
        data = b"".join(np.ascontiguousarray(f, np.uint8).tobytes()
                        for f in frames)
        subprocess.run(cmd, input=data, check=True, capture_output=True)
        return out_path
    from PIL import Image

    gif_path = os.path.splitext(out_path)[0] + ".gif"
    if audio_path:
        logger.warning("ffmpeg unavailable: writing silent GIF %s", gif_path)
    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(gif_path, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / fps), loop=0)
    return gif_path


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def mesh_side_by_side_frames(npz_paths, colors, smplx_model, faces,
                             max_frames: int = 600, panel_width: int = 320,
                             panel_height: int = 480) -> List[np.ndarray]:
    """Shared-camera multi-panel mesh frames on the SMPL-X model's device:
    the framing comes from panel 0's active vertices (the reference frames
    on GT / pred, :471-483) and every panel reuses its camera and floor."""
    verts, masks = [], []
    for p in npz_paths:
        d = np.load(p, allow_pickle=True)
        masks.append(active_frame_mask(np.asarray(d["poses"])[:max_frames]))
        verts.append(_vertices(p, smplx_model, max_frames))
    T = min(v.shape[0] for v in verts)
    verts = [v[:T] for v in verts]
    masks = [m[:T] for m in masks]
    camera_pose, floor_y = compute_auto_framing(verts[0], masks[0])
    panels = [
        mesh_frames(v, faces, m, camera_pose, floor_y, width=panel_width,
                    height=panel_height, mesh_color=c)
        for v, m, c in zip(verts, masks, colors)
    ]
    return [np.concatenate([p[t] for p in panels], axis=1)
            for t in range(T)]


def render_side_by_side(npz_paths: List[str], titles: List[str],
                        out_path: str, smplx_model=None, fps: int = 30,
                        audio_path: Optional[str] = None,
                        max_frames: int = 600, faces=None,
                        colors: Optional[List[tuple]] = None,
                        panel_width: int = 320,
                        panel_height: int = 480) -> str:
    """N-way side-by-side video of result npz files with one shared camera
    (reference render_gt_pred_side_by_side :443 /
    render_pred_vs_retrieval_side_by_side :507): meshes on the SMPL-X
    model's device when a model and faces are given, else skeleton line
    plots.  Returns the path written."""
    if smplx_model is not None and faces is not None:
        colors = colors or ([GT_COLOR, PRED_COLOR, RETR_COLOR]
                            [: len(npz_paths)])
        frames = mesh_side_by_side_frames(npz_paths, colors, smplx_model,
                                          faces, max_frames, panel_width,
                                          panel_height)
        return write_video(frames, out_path, fps=fps, audio_path=audio_path)
    joints = [joints_from_npz(p, smplx_model, max_frames) for p in npz_paths]
    rng = active_frame_range(np.load(npz_paths[0], allow_pickle=True)["poses"]
                             [:max_frames])
    joints = [j[rng] for j in joints]
    frames = skeleton_frames(joints, titles)
    return write_video(frames, out_path, fps=fps, audio_path=audio_path)


def render_gt_pred_side_by_side(gt_npz: str, pred_npz: str, out_path: str,
                                smplx_model=None, audio_path=None,
                                fps: int = 30, max_frames: int = 600,
                                faces=None) -> str:
    return render_side_by_side([gt_npz, pred_npz], ["GT", "Prediction"],
                               out_path, smplx_model, fps, audio_path,
                               max_frames, faces=faces,
                               colors=[GT_COLOR, PRED_COLOR])


def render_pred_vs_retrieval_side_by_side(pred_npz: str, retr_npz: str,
                                          out_path: str, smplx_model=None,
                                          audio_path=None, fps: int = 30,
                                          max_frames: int = 600,
                                          faces=None) -> str:
    return render_side_by_side([pred_npz, retr_npz],
                               ["Prediction", "Retrieval"], out_path,
                               smplx_model, fps, audio_path, max_frames,
                               faces=faces, colors=[PRED_COLOR, RETR_COLOR])


def render_smplx_debug_video(npz_path: str, out_path: str, smplx_model=None,
                             fps: int = 30, max_frames: int = 600,
                             faces=None) -> str:
    """Single-sequence debug video (reference :339)."""
    return render_side_by_side([npz_path], ["motion"], out_path, smplx_model,
                               fps, max_frames=max_frames, faces=faces,
                               colors=[PRED_COLOR])
