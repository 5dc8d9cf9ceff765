"""Rotation parameterisations: angle-axis <-> matrix <-> quaternion.

The port of monocularsfm_tpu/geometry/rotations.py (reference parity:
cv::Rodrigues, Registrant.cpp:96-97, and Ceres' AngleAxisRotatePoint,
CeresBundleOptimizer.cpp:29-36).  Branch-free batched tensor code with the
same Taylor-stabilised small-angle paths.

Conventions: rotations are world->camera; angle-axis vectors are (3,) with
magnitude = rotation angle in radians; quaternions are (w, x, y, z) to match
the COLMAP text export.
"""

from __future__ import annotations

import torch

from monocularsfm_torch.utils.precision import mm

_EPS = 1e-12


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def angle_axis_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula, batched over leading dims. aa: (..., 3) -> (..., 3, 3)."""
    theta2 = (aa * aa).sum(-1)
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-8
    sinc = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    cosc = torch.where(small, 0.5 - theta2 / 24.0,
                       (1.0 - torch.cos(theta)) / theta2)
    K = skew(aa)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(K.shape)
    return eye + sinc[..., None, None] * K + cosc[..., None, None] * mm(K, K)


def matrix_to_angle_axis(R: torch.Tensor) -> torch.Tensor:
    """Inverse Rodrigues, batched. R: (..., 3, 3) -> (..., 3), by way of
    the quaternion (stable near 0 and near pi)."""
    q = matrix_to_quaternion(R)
    w = q[..., 0]
    v = q[..., 1:]
    vnorm = torch.linalg.norm(v, dim=-1)
    angle = 2.0 * torch.atan2(vnorm, w)
    scale = torch.where(vnorm > 1e-12, angle / torch.clamp(vnorm, min=_EPS),
                        2.0 / torch.clamp(w, min=_EPS))
    return v * scale[..., None]


def matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix to unit quaternion (w, x, y, z), batched,
    branch-free: all four Shepperd candidates, the best-conditioned one
    selected per matrix."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw2 = torch.clamp(1.0 + tr, min=0.0)
    qx2 = torch.clamp(1.0 + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(1.0 - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(1.0 - m00 - m11 + m22, min=0.0)

    def _safe(x):
        return torch.clamp(torch.sqrt(x), min=1e-12)

    sw, sx, sy, sz = _safe(qw2), _safe(qx2), _safe(qy2), _safe(qz2)
    cand_w = torch.stack([sw, (m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw], -1)
    cand_x = torch.stack([(m21 - m12) / sx, sx, (m01 + m10) / sx, (m02 + m20) / sx], -1)
    cand_y = torch.stack([(m02 - m20) / sy, (m01 + m10) / sy, sy, (m12 + m21) / sy], -1)
    cand_z = torch.stack([(m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz, sz], -1)
    mags = torch.stack([qw2, qx2, qy2, qz2], dim=-1)
    best = torch.argmax(mags, dim=-1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], dim=-2)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :] * 0.5
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) to rotation matrix, batched."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1)
    row1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1)
    row2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def angle_axis_rotate_point(aa: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Rotate points by angle-axis without forming the matrix (Ceres'
    AngleAxisRotatePoint, batched). aa: (..., 3), pts: (..., 3)."""
    theta2 = (aa * aa).sum(-1)
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-8
    cos_t = torch.where(small, 1.0 - theta2 / 2.0, torch.cos(theta))
    sinc = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    w_cross_p = torch.cross(aa.expand_as(pts), pts, dim=-1)
    w_dot_p = (aa * pts).sum(-1, keepdim=True)
    one_m_cos_over_t2 = torch.where(small, 0.5 - theta2 / 24.0,
                                    (1.0 - cos_t) / theta2)
    return (pts * cos_t[..., None] + w_cross_p * sinc[..., None]
            + aa * (w_dot_p * one_m_cos_over_t2[..., None]))
