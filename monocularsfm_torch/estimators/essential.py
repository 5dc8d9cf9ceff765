"""Essential-matrix estimation, decomposition, and pose recovery.

The port of monocularsfm_tpu/estimators/essential.py (reference parity:
Initializer::RecoverPoseFromFundanmental, cv::findEssentialMat +
cv::recoverPose on the F-inliers, Initializer.cpp:306-360).  E is estimated
by RANSAC on K^-1-normalised coordinates (8-point + (1,1,0) singular-value
projection), decomposed into the 4 (R, t) candidates, and the candidate is
picked by cheirality over the inliers, as recoverPose does.  The uniform
draws are an argument (see estimators/ransac.py).
"""

from __future__ import annotations

import numpy as np
import torch

from monocularsfm_torch.estimators.fundamental import (
    _eight_point_rows,
    sampson_distance,
)
from monocularsfm_torch.estimators.ransac import (
    sample_minimal_sets,
    score_hypotheses,
)
from monocularsfm_torch.geometry.triangulation import triangulate_two_view
from monocularsfm_torch.utils.linalg import eigh_vectors, svd
from monocularsfm_torch.utils.precision import mm


def _enforce_essential(E: torch.Tensor) -> torch.Tensor:
    """Project onto the essential manifold: singular values (1, 1, 0)."""
    U, _, Vh = svd(E)
    S = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return mm(U, S[:, None] * Vh)


def _fit_e(rows: torch.Tensor, weights: torch.Tensor | None = None):
    """E from constraint rows (..., R, 9), optionally weighted."""
    if weights is not None:
        rows = rows * weights[..., None]
    V = eigh_vectors(rows.transpose(-1, -2) @ rows)
    E = V[..., :, 0].reshape(V.shape[:-2] + (3, 3))
    return _enforce_essential(E)


def pixels_to_normalized(K: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Pixel -> normalized camera coords (inputs pre-undistorted)."""
    return torch.stack([(uv[..., 0] - K[..., 0, 2]) / K[..., 0, 0],
                        (uv[..., 1] - K[..., 1, 2]) / K[..., 1, 1]], dim=-1)


def _count(E, xn1, xn2, mask, thr2):
    return ((sampson_distance(E, xn1, xn2) <= thr2) & mask).sum(-1)


def estimate_essential_ransac(u: torch.Tensor, xn1: torch.Tensor,
                              xn2: torch.Tensor, mask: torch.Tensor,
                              threshold_norm: float):
    """RANSAC E on normalized coords; threshold_norm ~ threshold_px / focal.

    u: (M, N) uniform draws, xn1/xn2: (N, 2), mask: (N,).  Returns a dict
    of E, inliers, num_inliers, success."""
    xn1 = xn1.float()
    xn2 = xn2.float()
    sets = sample_minimal_sets(u, 8, mask)                   # (M, 8)
    E = _fit_e(_eight_point_rows(xn1[sets], xn2[sets]))      # (M, 3, 3)
    res = sampson_distance(E, xn1[None], xn2[None])          # (M, N)
    thr2 = float(np.float32(threshold_norm) ** 2)  # squared in f32, as the reference
    best, _, _ = score_hypotheses(res, mask, thr2)
    E_best = E[best]
    del res
    rows_all = _eight_point_rows(xn1, xn2)
    for _ in range(2):
        w = ((sampson_distance(E_best, xn1, xn2) <= thr2) & mask).float()
        E2 = _fit_e(rows_all, w)
        keep = _count(E2, xn1, xn2, mask, thr2) >= _count(E_best, xn1, xn2, mask, thr2)
        E_best = torch.where(keep, E2, E_best)
    inliers = (sampson_distance(E_best, xn1, xn2) <= thr2) & mask
    num_inl = inliers.sum()
    return {"E": E_best, "inliers": inliers, "num_inliers": num_inl,
            "success": num_inl >= 8}


def decompose_essential(E: torch.Tensor):
    """E -> 4 candidate (R, t) pairs, stacked: R (4,3,3), t (4,3), |t| = 1."""
    U, _, Vh = svd(E)
    U = U * torch.sign(torch.linalg.det(U))[..., None, None]
    Vh = Vh * torch.sign(torch.linalg.det(Vh))[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = mm(U, W, Vh)
    R2 = mm(U, W.T, Vh)
    t = U[..., :, 2]
    return torch.stack([R1, R1, R2, R2], dim=-3), torch.stack([t, -t, t, -t], dim=-2)


def cheirality(Rs: torch.Tensor, ts: torch.Tensor, xn1: torch.Tensor,
               xn2: torch.Tensor, mask: torch.Tensor):
    """Triangulate every candidate motion (camera 1 at identity).

    Rs: (k, 3, 3), ts: (k, 3), xn1/xn2: (N, 2).  Returns (Xs (k, N, 3),
    fronts (k, N) in front of both cameras and masked, counts (k,))."""
    eye = torch.eye(3, dtype=Rs.dtype, device=Rs.device)
    zero = torch.zeros(3, dtype=Rs.dtype, device=Rs.device)
    Xs = triangulate_two_view(eye, zero, Rs[:, None], ts[:, None],
                              xn1[None], xn2[None])          # (k, N, 3)
    z1 = Xs[..., 2]
    z2 = (Xs @ Rs.transpose(-1, -2) + ts[:, None])[..., 2]
    fronts = (z1 > 0) & (z2 > 0) & mask
    return Xs, fronts, fronts.sum(-1)


def recover_pose_from_essential(E, xn1, xn2, mask):
    """cv::recoverPose equivalent: the (R, t) with the most points in front
    of both cameras (the first on ties).  Camera 1 is the identity; returns
    (R, t, points3d (N, 3), front_mask (N,))."""
    Rs, ts = decompose_essential(E)
    Xs, fronts, counts = cheirality(Rs, ts, xn1, xn2, mask)
    best = torch.argmax(counts)
    return Rs[best], ts[best], Xs[best], fronts[best]
