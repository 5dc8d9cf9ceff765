"""OpenCV's four-term lens (k1, k2, p1, p2) and its inverse, in float64.

The forward model maps ideal normalised coordinates x = (x, y), r^2 =
x^2 + y^2, to distorted ones

    x_d = x (1 + k1 r^2 + k2 r^4) + 2 p1 x y + p2 (r^2 + 2 x^2)
    y_d = y (1 + k1 r^2 + k2 r^4) + p1 (r^2 + 2 y^2) + 2 p2 x y

(cv::projectPoints without k3).  The inverse has no closed form; it is the
fixed-point iteration x <- (x_d - tangential(x)) / radial(x) that
cv::undistortPoints runs, here iterated until it stops moving.  Used by the
benchmark's generator (every observation projected through the lens) and by
the check (the database's keypoints undistorted again, independently of
the program).  Nothing here imports the program.
"""

from __future__ import annotations

import torch

F64 = torch.float64
# The iteration stops once no coordinate moves by more than this
# (normalised units; 1e-15 is 4e-12 px at f = 3840).
TOLERANCE = 1e-15
MAX_ITERATIONS = 1000


def _coeffs(cam: dict) -> tuple[float, float, float, float]:
    return tuple(float(cam.get(k, 0.0)) for k in ("k1", "k2", "p1", "p2"))


def _terms(x: torch.Tensor, k):
    """(radial, tangential) of ideal normalised coordinates (..., 2)."""
    k1, k2, p1, p2 = k
    u, v = x[..., 0], x[..., 1]
    r2 = u * u + v * v
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    tangential = torch.stack([2.0 * p1 * u * v + p2 * (r2 + 2.0 * u * u),
                              p1 * (r2 + 2.0 * v * v) + 2.0 * p2 * u * v], -1)
    return radial, tangential


def distort_normalized(x, cam: dict) -> torch.Tensor:
    """(..., 2) ideal normalised coordinates -> distorted ones."""
    x = torch.as_tensor(x, dtype=F64)
    radial, tangential = _terms(x, _coeffs(cam))
    return x * radial[..., None] + tangential


def undistort_normalized(xd, cam: dict) -> torch.Tensor:
    """(..., 2) distorted normalised coordinates -> ideal ones, by the
    fixed-point iteration run until no coordinate moves by more than
    TOLERANCE.  Raises where it does not settle."""
    xd = torch.as_tensor(xd, dtype=F64)
    k = _coeffs(cam)
    x = xd.clone()
    for _ in range(MAX_ITERATIONS):
        radial, tangential = _terms(x, k)
        nxt = (xd - tangential) / radial[..., None]
        moved = float((nxt - x).abs().max()) if x.numel() else 0.0
        x = nxt
        if moved <= TOLERANCE:
            return x
    raise ArithmeticError(f"the lens inverse moved {moved:.3e} after "
                          f"{MAX_ITERATIONS} iterations")


def _pixel_frame(uv, cam: dict):
    uv = torch.as_tensor(uv, dtype=F64)
    return (uv, uv.new_tensor([cam["cx"], cam["cy"]]),
            uv.new_tensor([cam["fx"], cam["fy"]]))


def distort_pixels(uv, cam: dict) -> torch.Tensor:
    """(..., 2) pixels of the ideal pinhole -> pixels of a frame taken
    through the lens (the same fx, fy, cx, cy)."""
    uv, c, f = _pixel_frame(uv, cam)
    return distort_normalized((uv - c) / f, cam) * f + c


def undistort_pixels(uv, cam: dict) -> torch.Tensor:
    """(..., 2) pixels of a frame taken through the lens -> pixels of the
    ideal pinhole with the same fx, fy, cx, cy."""
    uv, c, f = _pixel_frame(uv, cam)
    return undistort_normalized((uv - c) / f, cam) * f + c
