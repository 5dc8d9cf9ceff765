"""Batched 8-point fundamental-matrix estimation with RANSAC.

The port of monocularsfm_tpu/estimators/fundamental.py (reference parity:
cv::findFundamentalMat RANSAC in FeatureUtils::FilterMatches,
FeatureUtils.cpp:176-206).  For a batch of pairs, M hypotheses each are
solved at once: Hartley normalisation, the 8x9 nullspace as the smallest
eigenvector of A^T A (batched eigh), rank-2 enforcement by batched SVD of
the 3x3 F, then all M x N Sampson residuals in one pass; two least-squares
refits on the winner's inliers follow.  Everything is float32 with full
fp32 products (the package disables TF32).  An eigenvector's sign is
arbitrary and may differ from XLA's; the Sampson distance ignores it.
"""

from __future__ import annotations

import math

import torch

from monocularsfm_torch.estimators.ransac import (
    sample_minimal_sets,
    score_hypotheses,
)
from monocularsfm_torch.utils.linalg import eigh_vectors, svd
from monocularsfm_torch.utils.precision import mm


def _hartley_normalize(x: torch.Tensor, mask: torch.Tensor):
    """Similarity transform sending masked points to mean 0, RMS sqrt(2).

    x: (..., N, 2), mask: (..., N).  Returns (x_norm, T (..., 3, 3))."""
    w = mask.to(x.dtype)
    n = torch.clamp(w.sum(-1), min=1.0)
    mean = (x * w[..., None]).sum(-2) / n[..., None]            # (..., 2)
    d = torch.sqrt((((x - mean[..., None, :]) ** 2).sum(-1) * w).sum(-1) / n)
    s = math.sqrt(2.0) / torch.clamp(d, min=1e-12)
    T = torch.zeros(x.shape[:-2] + (3, 3), dtype=x.dtype, device=x.device)
    T[..., 0, 0] = s
    T[..., 1, 1] = s
    T[..., 0, 2] = -s * mean[..., 0]
    T[..., 1, 2] = -s * mean[..., 1]
    T[..., 2, 2] = 1.0
    return (x - mean[..., None, :]) * s[..., None, None], T


def _eight_point_rows(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Epipolar constraint rows x2^T F x1 = 0. x1/x2: (..., 2) -> (..., 9)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    one = torch.ones_like(u1)
    return torch.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, one], dim=-1)


def _fit_f(rows: torch.Tensor, weights: torch.Tensor | None = None):
    """F from constraint rows (..., R, 9): smallest eigenvector of
    sum_r w_r a_r a_r^T, reshaped, projected to rank 2."""
    if weights is not None:
        rows = rows * weights[..., None]
    AtA = rows.transpose(-1, -2) @ rows
    V = eigh_vectors(AtA)
    F = V[..., :, 0].reshape(V.shape[:-2] + (3, 3))
    U, S, Vh = svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    return mm(U, S[..., :, None] * Vh)


def sampson_distance(F: torch.Tensor, x1: torch.Tensor,
                     x2: torch.Tensor) -> torch.Tensor:
    """Squared Sampson distance.  F: (..., 3, 3), x1/x2: (..., N, 2), with
    broadcasting leading dims -> (..., N)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    f = [[F[..., i, j, None] for j in range(3)] for i in range(3)]
    fx = [f[i][0] * u1 + f[i][1] * v1 + f[i][2] for i in range(3)]   # F x1
    ftx = [f[0][i] * u2 + f[1][i] * v2 + f[2][i] for i in range(2)]  # F^T x2
    num = (u2 * fx[0] + v2 * fx[1] + fx[2]) ** 2
    den = fx[0] ** 2 + fx[1] ** 2 + ftx[0] ** 2 + ftx[1] ** 2
    return num / torch.clamp(den, min=1e-12)


def estimate_fundamental_ransac_batch(u: torch.Tensor, x1: torch.Tensor,
                                      x2: torch.Tensor, mask: torch.Tensor,
                                      threshold_px: float = 4.0):
    """F-RANSAC over a batch of pairs.

    u: (B, M, N) uniform draws (M hypotheses), x1/x2: (B, N, 2) pixels,
    mask: bool (B, N).  Thresholds the squared Sampson distance against
    threshold_px^2.  Returns a dict of F (B, 3, 3), inliers bool (B, N),
    num_inliers (B,), success (B,)."""
    x1 = x1.float()
    x2 = x2.float()
    B = x1.shape[0]
    x1n, T1 = _hartley_normalize(x1, mask)
    x2n, T2 = _hartley_normalize(x2, mask)

    sets = sample_minimal_sets(u, 8, mask)                  # (B, M, 8)
    bi = torch.arange(B, device=x1.device)[:, None, None]
    F_n = _fit_f(_eight_point_rows(x1n[bi, sets], x2n[bi, sets]))
    # Denormalise: F = T2^T F_n T1; residuals in pixel units.
    F_px = mm(T2.transpose(-1, -2)[:, None], F_n, T1[:, None])  # (B, M, 3, 3)
    res = sampson_distance(F_px, x1[:, None], x2[:, None])  # (B, M, N)
    thr2 = float(threshold_px) ** 2
    best, _, _ = score_hypotheses(res, mask, thr2)
    F_best = F_px[torch.arange(B, device=x1.device), best]  # (B, 3, 3)
    del res

    # Local optimisation: two reweighted least-squares refits on the inliers,
    # each kept only if it does not lose inliers.
    rows_all = _eight_point_rows(x1n, x2n)                  # (B, N, 9)
    for _ in range(2):
        inl_old = (sampson_distance(F_best, x1, x2) <= thr2) & mask
        F2 = mm(T2.transpose(-1, -2), _fit_f(rows_all, inl_old.float()), T1)
        inl_new = (sampson_distance(F2, x1, x2) <= thr2) & mask
        keep = inl_new.sum(-1) >= inl_old.sum(-1)
        F_best = torch.where(keep[:, None, None], F2, F_best)
    inliers = (sampson_distance(F_best, x1, x2) <= thr2) & mask
    num_inl = inliers.sum(-1)
    # Normalise scale for determinism (F is homogeneous).
    F_best = F_best / torch.clamp(
        torch.linalg.norm(F_best, dim=(-2, -1), keepdim=True), min=1e-12)
    return {
        "F": F_best,
        "inliers": inliers,
        "num_inliers": num_inl,
        "success": num_inl >= 8,
    }


def estimate_fundamental_ransac(u: torch.Tensor, x1: torch.Tensor,
                                x2: torch.Tensor, mask: torch.Tensor,
                                threshold_px: float = 4.0):
    """One pair: u (M, N), x1/x2 (N, 2), mask (N,).  Same dict, unbatched."""
    out = estimate_fundamental_ransac_batch(
        u[None], x1[None], x2[None], mask[None], threshold_px)
    return {k: v[0] for k, v in out.items()}
