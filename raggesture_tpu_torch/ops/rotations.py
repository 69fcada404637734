"""6d rotation features -> axis-angle, for the codec decode.

Port of the structure-of-arrays path of ``raggesture_tpu/ops/rotations.py``
(``d6_feature_to_aa``: Gram-Schmidt 6d -> matrix -> quaternion (Shepperd,
candidate chosen by the largest |component|, floored at 0.1) ->
axis-angle), with the same branches near angle 0 and π.
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
