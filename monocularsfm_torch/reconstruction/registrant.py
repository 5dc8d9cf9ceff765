"""Image registration: absolute pose from 2D-3D correspondences.

The port of monocularsfm_tpu/reconstruction/registrant.py (reference
parity: src/Reconstruction/Registrant.cpp — solvePnPRansac with >= 15
inliers / 4 px / conf .9999, Registrant.h:22-27).  The batched EPnP RANSAC
+ GN polish of estimators/pnp.py runs on `device`; the uniform draws come
from the registrant's own torch.Generator, seeded with 7 (the reference's
PRNGKey(7)); `_draw` is the one place they are made.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from monocularsfm_torch.config import RegistrantConfig
from monocularsfm_torch.estimators import (
    estimate_pnp_ransac,
    num_ransac_iterations,
    rounds_to_confidence,
)
from monocularsfm_torch.estimators.pnp import SAMPLE_SIZE


@dataclasses.dataclass
class RegistrantStatistics:
    is_succeed: bool = False
    num_point2D_3D_correspondences: int = 0
    num_inliers: int = 0
    ave_residual: float = 0.0


def _pad_cap(n: int, minimum: int = 512) -> int:
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


class Registrant:
    def __init__(self, K: np.ndarray, config: RegistrantConfig | None = None,
                 device="cuda"):
        self.K = np.asarray(K, np.float64)
        self.cfg = config or RegistrantConfig()
        if self.cfg.pnp_method not in SAMPLE_SIZE:
            raise NotImplementedError(
                f"pnp_method {self.cfg.pnp_method!r} is not ported; the port "
                f"has {sorted(SAMPLE_SIZE)}")
        from monocularsfm_torch.reconstruction.map_builder import resolve_device

        self.device = resolve_device(device)
        self._gen = torch.Generator(self.device).manual_seed(7)

    def _draw(self, num_hyps: int, cap: int) -> torch.Tensor:
        """One round's uniform draws (num_hyps, cap)."""
        return torch.rand((num_hyps, cap), generator=self._gen, device=self.device)

    def register(self, xyz: np.ndarray, uv: np.ndarray):
        """Returns (stats, R, t, inlier_mask (n,)) — Nones on failure."""
        cfg = self.cfg
        stats = RegistrantStatistics(num_point2D_3D_correspondences=len(xyz))
        if len(xyz) < cfg.abs_pose_min_num_inliers:
            return stats, None, None, None
        n = len(xyz)
        cap = _pad_cap(n)
        X = np.zeros((cap, 3), np.float32)
        U = np.zeros((cap, 2), np.float32)
        m = np.zeros(cap, bool)
        X[:n], U[:n], m[:n] = xyz, uv, True
        Kt = torch.from_numpy(self.K.astype(np.float32)).to(self.device)
        Xt, Ut, mt = (torch.from_numpy(v).to(self.device) for v in (X, U, m))
        M = cfg.ransac_iterations

        def run_round():
            return estimate_pnp_ransac(
                self._draw(M, cap), Kt, Xt, Ut, mt,
                threshold_px=cfg.abs_pose_max_error_px, method=cfg.pnp_method)

        # Adaptive continuation: more identically-shaped rounds until the
        # classic 1-(1-w^m)^k >= confidence bound holds for the best model
        # (cv::solvePnPRansac's adaptive termination, inverted for batches),
        # up to the reference's 10000-hypothesis ceiling.
        sample_size = SAMPLE_SIZE[cfg.pnp_method]
        max_rounds = max(1, -(-10000 // max(M, 1)))
        out = run_round()
        rounds = 1
        while rounds < rounds_to_confidence(
            cfg.ransac_confidence, int(out["num_inliers"]), n,
            sample_size, M, max_rounds=max_rounds,
        ):
            out2 = run_round()
            if int(out2["num_inliers"]) > int(out["num_inliers"]):
                out = out2
            rounds += 1
        need = num_ransac_iterations(
            cfg.ransac_confidence, int(out["num_inliers"]) / max(n, 1),
            sample_size,
        )
        if need > rounds * M:
            from monocularsfm_torch.utils.caps import warn_cap

            warn_cap(
                "PnP RANSAC stopped at max_rounds=%d (%d hypotheses) with "
                "the %.4f confidence bound unmet (needs %d)",
                max_rounds, rounds * M, cfg.ransac_confidence, need,
            )
        stats.num_inliers = int(out["num_inliers"])
        stats.ave_residual = float(out["mean_inlier_error_px"])
        if stats.num_inliers < cfg.abs_pose_min_num_inliers:
            return stats, None, None, None
        stats.is_succeed = True
        inl = out["inliers"].cpu().numpy()[:n]
        return (stats, out["R"].double().cpu().numpy(),
                out["t"].double().cpu().numpy(), inl)
