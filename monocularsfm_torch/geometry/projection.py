"""Pinhole projection, reprojection error, cheirality and parallax.

The port of monocularsfm_tpu/geometry/projection.py (reference parity:
src/Reconstruction/Projection.cpp — HasPositiveDepth :6-68,
CalculateReprojectionError :73-145, CalculateParallaxAngle :149-194).
Plain tensor code over trailing axes; poses are world->camera,
x_cam = R @ X + t.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def camera_center(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Camera center in world coords: C = -R^T t. R: (...,3,3), t: (...,3)."""
    return -(R.transpose(-1, -2) @ t[..., None])[..., 0]


def transform_to_camera(R: torch.Tensor, t: torch.Tensor,
                        X: torch.Tensor) -> torch.Tensor:
    """World points into the camera frame. X: (..., 3)."""
    return (R @ X[..., None])[..., 0] + t


def has_positive_depth(R, t, X) -> torch.Tensor:
    """Cheirality mask: depth (z in the camera frame) > 0."""
    return transform_to_camera(R, t, X)[..., 2] > 0


def project(K: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
            X: torch.Tensor) -> torch.Tensor:
    """Project world points to pixels. Returns (..., 2).  Points behind the
    camera still give finite coordinates (z clamped away from 0)."""
    xc = transform_to_camera(R, t, X)
    z = xc[..., 2:3]
    z = torch.where(z.abs() < _EPS, torch.where(z < 0, -_EPS, _EPS), z)
    xn = xc[..., :2] / z
    u = K[..., 0, 0] * xn[..., 0] + K[..., 0, 2]
    v = K[..., 1, 1] * xn[..., 1] + K[..., 1, 2]
    return torch.stack([u, v], dim=-1)


def calculate_reprojection_error(K, R, t, X, uv) -> torch.Tensor:
    """L2 pixel reprojection error. uv: (..., 2) observed -> (...,)."""
    return torch.linalg.norm(project(K, R, t, X) - uv, dim=-1)


def calculate_parallax_angle_deg(C1: torch.Tensor, C2: torch.Tensor,
                                 X: torch.Tensor) -> torch.Tensor:
    """Parallax angle at X between camera centers C1, C2, by the law of
    cosines: degrees, NaN/degenerate -> 0, folded to <= 90."""
    d1 = torch.linalg.norm(X - C1, dim=-1)
    d2 = torch.linalg.norm(X - C2, dim=-1)
    baseline = torch.linalg.norm(C1 - C2, dim=-1)
    denom = 2.0 * d1 * d2
    cosang = (d1 * d1 + d2 * d2 - baseline * baseline) / torch.clamp(denom, min=_EPS)
    ang = torch.arccos(torch.clamp(cosang, -1.0, 1.0)) * (180.0 / math.pi)
    ang = torch.where(torch.isfinite(ang), ang, 0.0)
    ang = torch.where(denom <= _EPS, 0.0, ang)
    return torch.where(ang > 90.0, 180.0 - ang, ang)
