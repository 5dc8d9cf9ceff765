"""Batched 4-point homography estimation, RANSAC, and decomposition.

The port of monocularsfm_tpu/estimators/homography.py (reference parity:
Initializer::FindHomography, cv::findHomography with RANSAC at 12 px,
Initializer.cpp:103-129, and the candidate test of
cv::decomposeHomographyMat in RecoverPoseFromHomography, :168-296).  The
decomposition is the Faugeras-Lustman SVD construction: 4 candidate
(R, t, n), scored downstream by cheirality like the essential path.  The
uniform draws are an argument (see estimators/ransac.py).
"""

from __future__ import annotations

import numpy as np
import torch

from monocularsfm_torch.estimators.fundamental import _hartley_normalize
from monocularsfm_torch.estimators.ransac import (
    sample_minimal_sets,
    score_hypotheses,
)
from monocularsfm_torch.utils.linalg import eigh_vectors, svd
from monocularsfm_torch.utils.precision import mm


def _dlt_rows(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Two DLT rows per correspondence for H x1 ~ x2. (..., 2) -> (..., 2, 9)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    one = torch.ones_like(u1)
    zero = torch.zeros_like(u1)
    r0 = torch.stack([u1, v1, one, zero, zero, zero, -u2 * u1, -u2 * v1, -u2], -1)
    r1 = torch.stack([zero, zero, zero, u1, v1, one, -v2 * u1, -v2 * v1, -v2], -1)
    return torch.stack([r0, r1], dim=-2)


def _fit_h(x1: torch.Tensor, x2: torch.Tensor,
           weights: torch.Tensor | None = None) -> torch.Tensor:
    """H from correspondences (..., R, 2), optionally weighted per point."""
    rows = _dlt_rows(x1, x2)                                 # (..., R, 2, 9)
    if weights is not None:
        rows = rows * weights[..., None, None]
    rows = rows.reshape(rows.shape[:-3] + (-1, 9))
    V = eigh_vectors(rows.transpose(-1, -2) @ rows)
    return V[..., :, 0].reshape(V.shape[:-2] + (3, 3))


def transfer_error(H: torch.Tensor, x1: torch.Tensor,
                   x2: torch.Tensor) -> torch.Tensor:
    """Squared forward transfer error |H x1 - x2|^2 (OpenCV RANSAC's
    measure). H: (..., 3, 3), x1/x2: (..., N, 2) -> (..., N)."""
    h = [[H[..., i, j, None] for j in range(3)] for i in range(3)]
    u, v = x1[..., 0], x1[..., 1]
    y = [h[i][0] * u + h[i][1] * v + h[i][2] for i in range(3)]
    w = torch.where(y[2].abs() < 1e-12, 1e-12, y[2])
    return (y[0] / w - x2[..., 0]) ** 2 + (y[1] / w - x2[..., 1]) ** 2


def symmetric_transfer_error(H: torch.Tensor, Hinv: torch.Tensor,
                             x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Mean of the forward (H x1 against x2) and backward (Hinv x2 against
    x1) squared transfer errors, (..., N)."""
    return 0.5 * (transfer_error(H, x1, x2) + transfer_error(Hinv, x2, x1))


def estimate_homography_ransac(u: torch.Tensor, x1: torch.Tensor,
                               x2: torch.Tensor, mask: torch.Tensor,
                               threshold_px: float = 12.0):
    """RANSAC 4-point H in pixel coords.

    u: (M, N) uniform draws, x1/x2: (N, 2), mask: (N,).  Returns a dict of
    H (scaled so H[2, 2] = 1), inliers, num_inliers, success."""
    x1 = x1.float()
    x2 = x2.float()
    # Hartley-normalise: the raw pixel DLT's A^T A spans ~1e11 in f32.
    x1n, T1 = _hartley_normalize(x1, mask)
    x2n, T2 = _hartley_normalize(x2, mask)
    T2inv = torch.linalg.inv_ex(T2)[0]
    sets = sample_minimal_sets(u, 4, mask)                   # (M, 4)
    H = mm(T2inv, _fit_h(x1n[sets], x2n[sets]), T1)          # (M, 3, 3)
    res = transfer_error(H, x1[None], x2[None])              # (M, N)
    thr2 = float(np.float32(threshold_px) ** 2)
    best, _, _ = score_hypotheses(res, mask, thr2)
    H_best = H[best]
    del res

    def count(Hc):
        return ((transfer_error(Hc, x1, x2) <= thr2) & mask).sum()

    for _ in range(2):
        w = ((transfer_error(H_best, x1, x2) <= thr2) & mask).float()
        H2 = mm(T2inv, _fit_h(x1n, x2n, w), T1)
        H_best = torch.where(count(H2) >= count(H_best), H2, H_best)
    inliers = (transfer_error(H_best, x1, x2) <= thr2) & mask
    num_inl = inliers.sum()
    h22 = H_best[2, 2]
    H_best = H_best / torch.where(h22.abs() > 1e-12, h22, 1.0)
    return {"H": H_best, "inliers": inliers, "num_inliers": num_inl,
            "success": num_inl >= 4}


def decompose_homography(H_euc: torch.Tensor):
    """Faugeras-Lustman decomposition of a Euclidean homography K^-1 H K.

    Returns (R (4,3,3), t (4,3), n (4,3)) candidate motions (|t| arbitrary
    scale).  The pure-rotation case collapses all candidates to
    R = s U Vt, t = 0."""
    U, S, Vh = svd(H_euc)
    d1, d2, d3 = S[0], S[1], S[2]
    s = torch.linalg.det(U) * torch.linalg.det(Vh)
    d1n = d1 / d2
    d3n = d3 / d2
    denom = torch.clamp(d1n ** 2 - d3n ** 2, min=1e-12)
    x1m = torch.sqrt(torch.clamp((d1n ** 2 - 1.0) / denom, min=0.0))
    x3m = torch.sqrt(torch.clamp((1.0 - d3n ** 2) / denom, min=0.0))
    sin_t_m = (d1n - d3n) * x1m * x3m
    cos_t = d1n * x3m ** 2 + d3n * x1m ** 2

    eps = torch.tensor([(1.0, 1.0), (1.0, -1.0), (-1.0, 1.0), (-1.0, -1.0)],
                       dtype=H_euc.dtype, device=H_euc.device)
    e1, e3 = eps[:, 0], eps[:, 1]
    x1, x3 = e1 * x1m, e3 * x3m                              # (4,)
    sin_t = e1 * e3 * sin_t_m
    zero = torch.zeros_like(x1)
    one = torch.ones_like(x1)
    ct = cos_t.expand_as(x1)
    Rp = torch.stack([
        torch.stack([ct, zero, -sin_t], -1),
        torch.stack([zero, one, zero], -1),
        torch.stack([sin_t, zero, ct], -1),
    ], dim=-2)                                               # (4, 3, 3)
    tp = (d1n - d3n) * torch.stack([x1, zero, -x3], -1)      # (4, 3)
    npl = torch.stack([x1, zero, x3], -1)
    R = s * mm(U, Rp, Vh)
    t = tp @ U.T
    nvec = npl @ Vh
    pure = (d1n - d3n) < 1e-5
    R = torch.where(pure, (s * mm(U, Vh)).expand_as(R), R)
    t = torch.where(pure, torch.zeros_like(t), t)
    return R, t, nvec
