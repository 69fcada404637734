"""Rotation conversions: 6d rotation features <-> axis-angle for the codec
encode and decode, axis-angle -> matrix for SMPL-X forward kinematics, and
the rest of the conversions between axis-angle, wxyz quaternions, matrices
and the 6d representation (the first two matrix ROWS), with the quaternion
helpers ``qmul``, ``qinv``, ``qrot`` and ``qslerp``.

Port of ``raggesture_tpu/ops/rotations.py``: the structure-of-arrays path
``d6_feature_to_aa`` (Gram-Schmidt 6d -> matrix -> quaternion (Shepperd,
candidate chosen by the largest |component|, floored at 0.1) ->
axis-angle) and ``aa_feature_to_6d`` (axis-angle -> quaternion -> the first
two matrix rows), with the same branches near angle 0 and π; and the
per-rotation functions on (..., 3) / (..., 4) / (..., 3, 3) / (..., 6)
tensors, through the same component formulas.
"""

from __future__ import annotations

import torch

_EPS = 1e-6


def _soa_planes(x: torch.Tensor, k: int):
    """(..., J*k) -> k dense (M,) component planes, M = prod(...)*J."""
    flat = x.reshape(x.shape[:-1] + (x.shape[-1] // k, k))
    return [flat[..., c].reshape(-1) for c in range(k)]


def _soa_pack(planes, batch_shape, j: int) -> torch.Tensor:
    out = torch.stack(planes, dim=-1)
    return out.reshape(tuple(batch_shape) + (j * len(planes),))


def _aa_to_quat_soa(ax, ay, az):
    """Axis-angle planes -> wxyz quaternion planes; below angle 1e-6 the
    Taylor branches (the codec input is near-zero poses)."""
    sq = ax * ax + ay * ay + az * az
    small = sq < _EPS ** 2
    angles = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    half = 0.5 * angles
    s = torch.where(small, 0.5 - sq / 48.0, torch.sin(half) / angles)
    w = torch.where(small, 1.0 - sq / 8.0, torch.cos(half))
    return w, ax * s, ay * s, az * s


def _quat_to_matrix_soa(r, i, j, k):
    """wxyz quaternion planes -> the 9 rotation-matrix planes."""
    two_s = 2.0 / (r * r + i * i + j * j + k * k)
    return (
        1 - two_s * (j * j + k * k), two_s * (i * j - k * r),
        two_s * (i * k + j * r),
        two_s * (i * j + k * r), 1 - two_s * (i * i + k * k),
        two_s * (j * k - i * r),
        two_s * (i * k - j * r), two_s * (j * k + i * r),
        1 - two_s * (i * i + j * j),
    )


def _d6_to_matrix_soa(a1x, a1y, a1z, a2x, a2y, a2z):
    n1 = torch.sqrt(a1x * a1x + a1y * a1y + a1z * a1z).clamp_min(_EPS)
    b1x, b1y, b1z = a1x / n1, a1y / n1, a1z / n1
    d = b1x * a2x + b1y * a2y + b1z * a2z
    r2x, r2y, r2z = a2x - d * b1x, a2y - d * b1y, a2z - d * b1z
    n2 = torch.sqrt(r2x * r2x + r2y * r2y + r2z * r2z).clamp_min(_EPS)
    b2x, b2y, b2z = r2x / n2, r2y / n2, r2z / n2
    b3x = b1y * b2z - b1z * b2y
    b3y = b1z * b2x - b1x * b2z
    b3z = b1x * b2y - b1y * b2x
    return b1x, b1y, b1z, b2x, b2y, b2z, b3x, b3y, b3z


def _matrix_to_quat_soa(m00, m01, m02, m10, m11, m12, m20, m21, m22):
    def sqrt_pos(x):
        return torch.where(x > 0.0, torch.sqrt(torch.where(x > 0.0, x, 1.0)),
                           torch.zeros_like(x))

    qa_r = sqrt_pos(1.0 + m00 + m11 + m22)
    qa_i = sqrt_pos(1.0 + m00 - m11 - m22)
    qa_j = sqrt_pos(1.0 - m00 + m11 - m22)
    qa_k = sqrt_pos(1.0 - m00 - m11 + m22)
    cands = (
        (qa_r, (qa_r * qa_r, m21 - m12, m02 - m20, m10 - m01)),
        (qa_i, (m21 - m12, qa_i * qa_i, m10 + m01, m02 + m20)),
        (qa_j, (m02 - m20, m10 + m01, qa_j * qa_j, m12 + m21)),
        (qa_k, (m10 - m01, m20 + m02, m21 + m12, qa_k * qa_k)),
    )
    # argmax over the four |q| planes, first match wins
    best = torch.zeros_like(qa_r, dtype=torch.int32)
    cur = qa_r
    for n, (qa, _) in enumerate(cands[1:], start=1):
        best = torch.where(qa > cur, n, best)
        cur = torch.maximum(cur, qa)
    out = [torch.zeros_like(qa_r) for _ in range(4)]
    for n, (qa, cand) in enumerate(cands):
        inv = 1.0 / (2.0 * qa.clamp_min(0.1))
        sel = best == n
        for c in range(4):
            out[c] = torch.where(sel, cand[c] * inv, out[c])
    return tuple(out)


def _quat_to_aa_soa(r, i, j, k):
    sq = i * i + j * j + k * k
    norms = torch.where(sq > 0.0, torch.sqrt(torch.where(sq > 0.0, sq, 1.0)),
                        torch.zeros_like(sq))
    half = torch.atan2(norms, r)
    angles = 2.0 * half
    small = angles.abs() < _EPS
    s = torch.where(small, 0.5 - (angles * angles) / 48.0,
                    torch.sin(half) / torch.where(small, 1.0, angles))
    return i / s, j / s, k / s


def d6_feature_to_aa(x: torch.Tensor) -> torch.Tensor:
    """Flattened per-frame 6d features (..., J*6) -> (..., J*3) axis-angle."""
    j = x.shape[-1] // 6
    m = _d6_to_matrix_soa(*_soa_planes(x, 6))
    q = _matrix_to_quat_soa(*m)
    return _soa_pack(list(_quat_to_aa_soa(*q)), x.shape[:-1], j)


def aa_feature_to_6d(x: torch.Tensor) -> torch.Tensor:
    """Flattened per-frame axis-angle features (..., J*3) -> (..., J*6):
    the first two rows of each rotation matrix."""
    j = x.shape[-1] // 3
    m = _quat_to_matrix_soa(*_aa_to_quat_soa(*_soa_planes(x, 3)))
    return _soa_pack(list(m[:6]), x.shape[:-1], j)


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    """(..., 3) rotation vectors -> (..., 4) wxyz unit quaternions, with the
    Taylor branch below angle 1e-6 (exact zeros give the identity)."""
    return torch.stack(_aa_to_quat_soa(*axis_angle.unbind(-1)), dim=-1)


def quaternion_to_matrix(quaternions: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternions -> (..., 3, 3) rotation matrices."""
    m = torch.stack(_quat_to_matrix_soa(*quaternions.unbind(-1)), dim=-1)
    return m.reshape(quaternions.shape[:-1] + (3, 3))


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3) rotation matrices."""
    return quaternion_to_matrix(axis_angle_to_quaternion(axis_angle))


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrices -> (..., 4) wxyz quaternions (Shepperd,
    the candidate of the largest |component|)."""
    planes = matrix.reshape(matrix.shape[:-2] + (9,)).unbind(-1)
    return torch.stack(_matrix_to_quat_soa(*planes), dim=-1)


def quaternion_to_axis_angle(quaternions: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternions -> (..., 3) axis-angle; the Taylor branch
    is taken by small ANGLE (a w < 0 quaternion with a tiny vector part has
    angle ~2π and takes the generic branch)."""
    return torch.stack(_quat_to_aa_soa(*quaternions.unbind(-1)), dim=-1)


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrices -> (..., 3) axis-angle."""
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))


def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 6): the first two rows, flattened."""
    return matrix[..., :2, :].reshape(matrix.shape[:-2] + (6,))


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3) by Gram-Schmidt on the two stored rows."""
    m = torch.stack(_d6_to_matrix_soa(*d6.unbind(-1)), dim=-1)
    return m.reshape(d6.shape[:-1] + (3, 3))


def axis_angle_to_rotation_6d(axis_angle: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 6)."""
    return matrix_to_rotation_6d(axis_angle_to_matrix(axis_angle))


def rotation_6d_to_axis_angle(d6: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3) axis-angle."""
    return matrix_to_axis_angle(rotation_6d_to_matrix(d6))


def slerp_6d(x0: torch.Tensor, x1: torch.Tensor, w) -> torch.Tensor:
    """The long-form cross-fade of two 6d feature tensors: a plain lerp,
    which ``rotation_6d_to_matrix``'s Gram-Schmidt re-normalises."""
    return x0 * (1.0 - w) + x1 * w


def qmul(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (..., 4) wxyz quaternions."""
    w1, x1, y1, z1 = q.unbind(-1)
    w2, x2, y2, z2 = r.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def qinv(q: torch.Tensor) -> torch.Tensor:
    """The inverse of unit (..., 4) quaternions: the conjugate."""
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Vectors v (..., 3) rotated by unit quaternions q (..., 4)."""
    qvec = q[..., 1:]
    uv = torch.linalg.cross(qvec, v)
    uuv = torch.linalg.cross(qvec, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def qslerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation between unit quaternions, by the shorter
    arc; a lerp where they are nearly parallel."""
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    dot = (q0 * q1).sum(dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = dot.abs().clamp(-1.0, 1.0)
    near = dot > 1.0 - 1e-7
    theta = torch.arccos(torch.where(near, torch.zeros_like(dot), dot))
    sin_theta = torch.where(near, torch.ones_like(dot), torch.sin(theta))
    w0 = torch.where(near, 1.0 - t, torch.sin((1.0 - t) * theta) / sin_theta)
    w1 = torch.where(near, t, torch.sin(t * theta) / sin_theta)
    out = w0 * q0 + w1 * q1
    return out / torch.linalg.norm(out, dim=-1, keepdim=True)
