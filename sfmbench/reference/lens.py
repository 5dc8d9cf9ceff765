"""The radial lens x_d = x (1 + k1 |x|^2) and its inverse, in float64.

Used by the benchmark's renderer (every pixel's ray) and by the check (the
keypoints of the database undistorted again, independently of the
program's own undistortion).  Nothing here imports the program.
"""

from __future__ import annotations

import torch

F64 = torch.float64


def undistort_normalized(xd: torch.Tensor, k1: float,
                         iterations: int = 20) -> torch.Tensor:
    """(..., 2) distorted normalised coordinates -> undistorted, by the
    fixed-point iteration x <- x_d / (1 + k1 |x|^2)."""
    xd = xd.to(F64)
    x = xd.clone()
    for _ in range(iterations):
        x = xd / (1.0 + k1 * (x * x).sum(-1, keepdim=True))
    return x


def undistort_pixels(uv, cam: dict) -> torch.Tensor:
    """(..., 2) pixels of a frame taken through the lens -> pixels of the
    ideal pinhole with the same fx, fy, cx, cy."""
    uv = torch.as_tensor(uv, dtype=F64)
    c = uv.new_tensor([cam["cx"], cam["cy"]])
    f = uv.new_tensor([cam["fx"], cam["fy"]])
    return undistort_normalized((uv - c) / f, cam.get("k1", 0.0)) * f + c
