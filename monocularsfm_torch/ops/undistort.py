"""Iterative keypoint undistortion (radial-tangential model).

The port of monocularsfm_tpu/ops/undistort.py (reference parity: Map load
undistorts every keypoint once with cv::undistortPoints, Map.cpp:45-69).
The OpenCV (k1, k2, p1, p2) model has no closed-form inverse; like OpenCV
the inverse is a fixed-point iteration x <- (x_d - tangential(x)) /
radial(x).  Float32, like the reference.
"""

from __future__ import annotations

import torch


def distort(xn: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Apply (k1, k2, p1, p2) to normalized coords. (..., 2) -> (..., 2)."""
    k1, k2, p1, p2 = dist[0], dist[1], dist[2], dist[3]
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([x * radial + dx, y * radial + dy], dim=-1)


def undistort_normalized(xd: torch.Tensor, dist: torch.Tensor,
                         iterations: int = 8) -> torch.Tensor:
    """Invert `distort` by fixed-point iteration. xd: (..., 2) distorted."""
    k1, k2, p1, p2 = dist[0], dist[1], dist[2], dist[3]
    x = xd
    for _ in range(iterations):
        xx, yy = x[..., 0], x[..., 1]
        r2 = xx * xx + yy * yy
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        dx = 2.0 * p1 * xx * yy + p2 * (r2 + 2.0 * xx * xx)
        dy = p1 * (r2 + 2.0 * yy * yy) + 2.0 * p2 * xx * yy
        inv = 1.0 / torch.where(radial.abs() < 1e-9, 1e-9, radial)
        x = torch.stack([(xd[..., 0] - dx) * inv, (xd[..., 1] - dy) * inv], dim=-1)
    return x


def undistort_pixels(uv, K, dist, iterations: int = 8) -> torch.Tensor:
    """Pixel -> undistorted pixel (same K for reprojection afterwards).
    Accepts arrays or tensors; computes in float32 on the input's device
    (the CPU for host arrays)."""
    uv = torch.as_tensor(uv).float()
    K = torch.as_tensor(K, device=uv.device).float()
    dist = torch.as_tensor(dist, device=uv.device).float()
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    xd = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], dim=-1)
    xn = undistort_normalized(xd, dist, iterations=iterations)
    return torch.stack([xn[..., 0] * fx + cx, xn[..., 1] * fy + cy], dim=-1)
