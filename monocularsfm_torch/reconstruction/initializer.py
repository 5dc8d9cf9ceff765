"""Two-view bootstrap: H/F model selection, pose recovery, initial points.

The port of monocularsfm_tpu/reconstruction/initializer.py (reference
parity: src/Reconstruction/Initializer.cpp — RANSAC H (12 px) and F (4 px);
F-path if H/F inlier ratio < 0.7 and F inliers >= threshold, else H-path,
:54-64; success tests :400-413).  RANSAC, scoring and triangulation run on
`device` over a padded correspondence capacity; the acceptance tests run
on the host in float64, as in the reference.  The uniform draws come from
the initializer's own torch.Generator, seeded with 42 (the reference's
PRNGKey(42)); `_draw` is the one place they are made.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from monocularsfm_torch.config import InitializerConfig
from monocularsfm_torch.estimators import (
    estimate_essential_ransac,
    estimate_fundamental_ransac,
    estimate_homography_ransac,
    num_ransac_iterations,
    recover_pose_from_essential,
    rounds_to_confidence,
)
from monocularsfm_torch.estimators.essential import cheirality, pixels_to_normalized
from monocularsfm_torch.estimators.homography import decompose_homography


def _homography_motion(K, H, x1, x2, inl):
    """The H path on the device: Euclidean homography, Faugeras
    decomposition, cheirality triangulation of all 4 candidates.
    Returns (xn1, xn2, Rs, ts, Xs, fronts, counts)."""
    H_euc = torch.linalg.inv(K) @ H.float() @ K
    Rs, ts, _ = decompose_homography(H_euc)
    xn1 = pixels_to_normalized(K, x1)
    xn2 = pixels_to_normalized(K, x2)
    Xs, fronts, counts = cheirality(Rs, ts, xn1, xn2, inl)
    return xn1, xn2, Rs, ts, Xs, fronts, counts


@dataclasses.dataclass
class InitializerStatistics:
    is_succeed: bool = False
    method: str = ""            # "fundamental" | "homography"
    num_inliers: int = 0
    median_tri_angle: float = 0.0
    ave_tri_angle: float = 0.0
    ave_residual: float = 0.0
    fail_reason: str = "not attempted"


def _pad_cap(n: int, minimum: int = 512) -> int:
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


class Initializer:
    def __init__(self, K: np.ndarray, config: InitializerConfig | None = None,
                 device="cpu"):
        self.K = np.asarray(K, np.float64)
        self.cfg = config or InitializerConfig()
        self.device = torch.device(device)
        self._gen = torch.Generator(self.device).manual_seed(42)

    def _draw(self, num_hyps: int, cap: int) -> torch.Tensor:
        """One round's uniform draws (num_hyps, cap)."""
        return torch.rand((num_hyps, cap), generator=self._gen, device=self.device)

    def _adaptive(self, run, sample_size: int, num_valid: int, cap: int,
                  max_rounds: int | None = None):
        """Re-run identically-shaped hypothesis rounds until the classic
        RANSAC termination bound meets `ransac_confidence`; keeps the best
        round by inlier count."""
        M = self.cfg.ransac_iterations
        if max_rounds is None:
            # Reach the reference's 10000-hypothesis ceiling
            # (Initializer.cpp:103-159).
            max_rounds = max(1, -(-10000 // max(M, 1)))
        out = run(self._draw(M, cap))
        rounds = 1
        while rounds < rounds_to_confidence(
            self.cfg.ransac_confidence, int(out["num_inliers"]), num_valid,
            sample_size, M, max_rounds=max_rounds,
        ):
            out2 = run(self._draw(M, cap))
            if int(out2["num_inliers"]) > int(out["num_inliers"]):
                out = out2
            rounds += 1
        need = num_ransac_iterations(
            self.cfg.ransac_confidence,
            int(out["num_inliers"]) / max(num_valid, 1), sample_size,
        )
        if need > rounds * M:
            from monocularsfm_torch.utils.caps import warn_cap

            warn_cap(
                "initializer RANSAC stopped at max_rounds=%d (%d hypotheses) "
                "with the %.4f confidence bound unmet (needs %d)",
                max_rounds, rounds * M, self.cfg.ransac_confidence, need,
            )
        return out

    def initialize(self, uv1: np.ndarray, uv2: np.ndarray):
        """Try to bootstrap from correspondences of one image pair.

        Returns (stats, R2, t2, points3d (M,3), inlier_corr_indices (M,))
        with camera 1 at identity; Nones on failure."""
        cfg = self.cfg
        stats = InitializerStatistics()
        n = len(uv1)
        if n < 8:
            stats.fail_reason = "too few correspondences"
            return stats, None, None, None, None
        cap = _pad_cap(n)
        x1 = np.zeros((cap, 2), np.float32)
        x2 = np.zeros((cap, 2), np.float32)
        m = np.zeros(cap, bool)
        x1[:n], x2[:n], m[:n] = uv1, uv2, True
        x1t, x2t, mt = (torch.from_numpy(v).to(self.device) for v in (x1, x2, m))

        h_out = self._adaptive(
            lambda u: estimate_homography_ransac(
                u, x1t, x2t, mt, threshold_px=cfg.rel_pose_homography_error),
            sample_size=4, num_valid=n, cap=cap,
        )
        f_out = self._adaptive(
            lambda u: estimate_fundamental_ransac(
                u, x1t, x2t, mt, threshold_px=cfg.rel_pose_essential_error),
            sample_size=8, num_valid=n, cap=cap,
        )
        h_inl = int(h_out["num_inliers"])
        f_inl = int(f_out["num_inliers"])
        # Model selection (Initializer.cpp:54-64).
        use_f = (
            f_inl >= cfg.init_min_num_inliers
            and h_inl / max(f_inl, 1) < cfg.homography_ratio_threshold
        )
        if use_f:
            return self._pose_from_fundamental(stats, x1t, x2t, f_out, cap)
        return self._pose_from_homography(stats, x1t, x2t, h_out, h_inl)

    def _K(self) -> torch.Tensor:
        return torch.from_numpy(self.K.astype(np.float32)).to(self.device)

    # -- F path --------------------------------------------------------------
    def _pose_from_fundamental(self, stats, x1t, x2t, f_out, cap):
        cfg = self.cfg
        stats.method = "fundamental"
        K = self._K()
        xn1 = pixels_to_normalized(K, x1t)
        xn2 = pixels_to_normalized(K, x2t)
        focal = float(self.K[0, 0])
        # Re-estimate E on the F-inliers (deliberately not E = K^T F K —
        # the reference documents the same choice, Initializer.cpp:306-309).
        e_out = self._adaptive(
            lambda u: estimate_essential_ransac(
                u, xn1, xn2, f_out["inliers"],
                threshold_norm=cfg.rel_pose_essential_error / focal),
            sample_size=8, num_valid=int(f_out["num_inliers"]), cap=cap,
        )
        if int(e_out["num_inliers"]) < 8:
            stats.fail_reason = "essential estimation failed"
            return stats, None, None, None, None
        R, t, X, front = recover_pose_from_essential(
            e_out["E"], xn1, xn2, e_out["inliers"])
        return self._finish(stats, R, t, X, front, xn1, xn2)

    # -- H path --------------------------------------------------------------
    def _pose_from_homography(self, stats, x1t, x2t, h_out, h_inl):
        cfg = self.cfg
        stats.method = "homography"
        if h_inl < cfg.init_min_num_inliers:
            stats.num_inliers = h_inl
            stats.fail_reason = "too few homography inliers"
            return stats, None, None, None, None
        xn1, xn2, Rs, ts, Xs, fronts, counts = _homography_motion(
            self._K(), h_out["H"], x1t, x2t, h_out["inliers"])
        best = int(np.argmax(_host(counts)))
        return self._finish(stats, Rs[best], ts[best], Xs[best], fronts[best],
                            xn1, xn2)

    # -- shared acceptance ----------------------------------------------------
    def _finish(self, stats, R, t, X, front, xn1, xn2):
        """Per-point accept tests + global success criteria
        (Initializer.cpp:400-413)."""
        cfg = self.cfg
        R_np = _host(R).astype(np.float64)
        t_np = _host(t).astype(np.float64).reshape(3)
        X_np = _host(X).astype(np.float64)
        front_np = _host(front)

        # Reprojection residuals in pixels (both views).
        fx, fy = self.K[0, 0], self.K[1, 1]
        xn1_np = _host(xn1).astype(np.float64)
        xn2_np = _host(xn2).astype(np.float64)
        z1 = X_np[:, 2]
        z1s = np.where(np.abs(z1) < 1e-9, 1e-9, z1)
        p1 = X_np[:, :2] / z1s[:, None]
        xc2 = X_np @ R_np.T + t_np
        z2 = xc2[:, 2]
        z2s = np.where(np.abs(z2) < 1e-9, 1e-9, z2)
        p2 = xc2[:, :2] / z2s[:, None]
        r1 = np.linalg.norm((p1 - xn1_np) * [fx, fy], axis=1)
        r2 = np.linalg.norm((p2 - xn2_np) * [fx, fy], axis=1)
        resid = 0.5 * (r1 + r2)
        ok = front_np & (resid < cfg.init_max_error)

        # Parallax angles.
        C2 = -R_np.T @ t_np
        d1 = X_np
        d2 = X_np - C2
        cos = np.sum(d1 * d2, axis=1) / np.maximum(
            np.linalg.norm(d1, axis=1) * np.linalg.norm(d2, axis=1), 1e-12)
        ang = np.degrees(np.arccos(np.clip(cos, -1, 1)))
        ang = np.where(ang > 90, 180 - ang, ang)

        num_inl = int(ok.sum())
        stats.num_inliers = num_inl
        if num_inl < cfg.init_min_num_inliers:
            stats.fail_reason = "too few triangulated inliers"
            return stats, None, None, None, None
        stats.median_tri_angle = float(np.median(ang[ok]))
        stats.ave_tri_angle = float(np.mean(ang[ok]))
        stats.ave_residual = float(np.mean(resid[ok]))
        if (stats.median_tri_angle < cfg.init_min_tri_angle_deg
                or stats.ave_tri_angle < cfg.init_min_tri_angle_deg):
            stats.fail_reason = "insufficient triangulation angle"
            return stats, None, None, None, None
        if stats.ave_residual > cfg.init_max_residual_px:
            stats.fail_reason = "mean residual too large"
            return stats, None, None, None, None
        stats.is_succeed = True
        stats.fail_reason = ""
        idx = np.nonzero(ok)[0]
        return stats, R_np, t_np, X_np[idx], idx
