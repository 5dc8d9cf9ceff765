"""Batched DLT triangulation: two-view and masked n-view.

The port of monocularsfm_tpu/geometry/triangulation.py (reference parity:
Triangulator.cpp:87-117 accumulates A^T A over views and takes the smallest
eigenvector of the 4x4 system; Initializer.cpp:436-463 stacks the two-view
4x4 DLT).  Rows use normalized camera coordinates (pixels premultiplied by
K^-1), which keeps the system well-conditioned in float32.  The 4x4 eighs
go through the sliced batched helper, since one call can carry tens of
thousands of candidate points.
"""

from __future__ import annotations

import torch

from monocularsfm_torch.utils.linalg import eigh_vectors


def _normalized_rows(R: torch.Tensor, t: torch.Tensor,
                     xn: torch.Tensor) -> torch.Tensor:
    """Two DLT rows per view. R: (...,3,3), t: (...,3), xn: (...,2).
    Returns (..., 2, 4)."""
    P = torch.cat([R, t[..., None]], dim=-1)  # (..., 3, 4)
    r0 = xn[..., 0:1] * P[..., 2, :] - P[..., 0, :]
    r1 = xn[..., 1:2] * P[..., 2, :] - P[..., 1, :]
    return torch.stack([r0, r1], dim=-2)


def _smallest_eigvec_4x4(A: torch.Tensor) -> torch.Tensor:
    """Eigenvector of the smallest eigenvalue of symmetric (..., 4, 4)."""
    return eigh_vectors(A)[..., :, 0]


def _dehomogenize(h: torch.Tensor) -> torch.Tensor:
    w = h[..., 3:4]
    w = torch.where(w.abs() < 1e-12, 1e-12, w)
    return h[..., :3] / w


def triangulate_two_view(R1, t1, R2, t2, xn1, xn2) -> torch.Tensor:
    """Two-view DLT. xn1/xn2: (..., 2) normalized coords. Returns (..., 3)."""
    rows1 = _normalized_rows(R1, t1, xn1)
    rows2 = _normalized_rows(R2, t2, xn2)
    A = torch.cat(torch.broadcast_tensors(rows1, rows2), dim=-2)  # (..., 4, 4)
    AtA = A.transpose(-1, -2) @ A
    return _dehomogenize(_smallest_eigvec_4x4(AtA))


def triangulate_n_view(R: torch.Tensor, t: torch.Tensor, xn: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Masked n-view DLT over a fixed-width view window.

    R: (..., V, 3, 3), t: (..., V, 3), xn: (..., V, 2), mask: (..., V) bool.
    Invalid views contribute zero rows to A^T A.  Returns X: (..., 3)."""
    rows = _normalized_rows(R, t, xn) * mask[..., None, None].to(R.dtype)
    rows = rows.reshape(rows.shape[:-3] + (-1, 4))        # (..., 2V, 4)
    AtA = rows.transpose(-1, -2) @ rows
    return _dehomogenize(_smallest_eigvec_4x4(AtA))
