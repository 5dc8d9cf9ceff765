"""Batched multi-view triangulation with acceptance tests.

The port of monocularsfm_tpu/reconstruction/triangulator.py (reference
parity: src/Reconstruction/Triangulator.cpp — DLT normal matrix over views,
smallest eigenvector, :87-117; accept only if every view reprojects under
tri_max_error_px, :38-51, and some camera pair reaches tri_min_angle_deg of
parallax, :53-79).  Candidate tracks are padded to a fixed (B, T) window
and the batch triangulates and tests on `device` in one pass.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from monocularsfm_torch.config import TriangulatorConfig
from monocularsfm_torch.geometry.triangulation import triangulate_n_view


@dataclasses.dataclass
class TriangulatorStatistics:
    num_tried: int = 0
    num_triangulated: int = 0
    ave_residual: float = float("nan")  # NaN when zero tracks triangulate —
    # the reference's quirk (MapBuilder.cpp:569), kept.


def _triangulate_batch(K4, R, t, uv, valid, max_error_px, min_angle_deg):
    """R: (B,T,3,3), t: (B,T,3), uv: (B,T,2) pixels, valid: (B,T).

    Returns (X (B,3), accept (B,), mean_err (B,))."""
    fx, fy, cx, cy = K4[0], K4[1], K4[2], K4[3]
    xn = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], -1)
    X = triangulate_n_view(R, t, xn, valid)                   # (B, 3)
    # Reprojection errors in all valid views.
    xc = (R @ X[:, None, :, None])[..., 0] + t
    z = xc[..., 2]
    zs = torch.where(z.abs() < 1e-9, 1e-9, z)
    u = fx * xc[..., 0] / zs + cx
    v = fy * xc[..., 1] / zs + cy
    err = torch.sqrt((u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2)
    err = torch.where(valid, err, 0.0)
    err = torch.where(valid & (z <= 0), 1e9, err)  # cheirality: all views front
    all_ok = err.max(-1).values <= max_error_px

    # Pairwise parallax: some pair of valid views >= min angle.
    Cc = -(R.transpose(-1, -2) @ t[..., None])[..., 0]        # centers
    d = X[:, None, :] - Cc                                    # (B, T, 3)
    dn = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)
    cos = dn @ dn.transpose(-1, -2)
    ang = torch.rad2deg(torch.arccos(torch.clamp(cos, -1.0, 1.0)))
    ang = torch.where(ang > 90.0, 180.0 - ang, ang)
    T = valid.shape[1]
    not_self = ~torch.eye(T, dtype=torch.bool, device=valid.device)
    pair_ok = valid[:, :, None] & valid[:, None, :] & not_self
    ang_ok = (torch.where(pair_ok, ang, 0.0) >= min_angle_deg).any(-1).any(-1)

    nvalid = valid.sum(-1)
    accept = all_ok & ang_ok & (nvalid >= 2)
    mean_err = err.sum(-1) / torch.clamp(nvalid, min=1)
    return X, accept, mean_err


class Triangulator:
    def __init__(self, K: np.ndarray, config: TriangulatorConfig | None = None,
                 track_width: int = 16, batch_cap: int = 4096, device="cuda"):
        self.K = np.asarray(K, np.float64)
        self.cfg = config or TriangulatorConfig()
        self.T = track_width
        self.batch_cap = batch_cap
        from monocularsfm_torch.reconstruction.map_builder import resolve_device

        self.device = resolve_device(device)

    def triangulate_tracks(self, tracks, poses):
        """`tracks` is a list of lists of (image_id, uv); `poses` maps
        image_id -> (R, t).  Returns (X (n,3), accept (n,), mean_err (n,))."""
        n = len(tracks)
        if n == 0:
            return np.zeros((0, 3)), np.zeros(0, bool), np.zeros(0)
        out_X = np.zeros((n, 3))
        out_acc = np.zeros(n, bool)
        out_err = np.zeros(n)
        K4 = torch.tensor([self.K[0, 0], self.K[1, 1], self.K[0, 2], self.K[1, 2]],
                          dtype=torch.float32, device=self.device)
        for start in range(0, n, self.batch_cap):
            chunk = tracks[start : start + self.batch_cap]
            B = _pad_batch(len(chunk))
            T = self.T
            R = np.tile(np.eye(3, dtype=np.float32), (B, T, 1, 1))
            t = np.zeros((B, T, 3), np.float32)
            uv = np.zeros((B, T, 2), np.float32)
            valid = np.zeros((B, T), bool)
            for b, tr in enumerate(chunk):
                for s, (image_id, uv_s) in enumerate(tr[:T]):
                    Rb, tb = poses[image_id]
                    R[b, s] = Rb
                    t[b, s] = tb
                    uv[b, s] = uv_s
                    valid[b, s] = True
            X, acc, err = _triangulate_batch(
                K4, *(torch.from_numpy(a).to(self.device) for a in (R, t, uv, valid)),
                self.cfg.tri_max_error_px, self.cfg.tri_min_angle_deg)
            m = len(chunk)
            out_X[start : start + m] = X[:m].cpu().numpy()
            out_acc[start : start + m] = acc[:m].cpu().numpy()
            out_err[start : start + m] = err[:m].cpu().numpy()
        return out_X, out_acc, out_err


def _pad_batch(n: int, minimum: int = 256) -> int:
    cap = minimum
    while cap < n:
        cap *= 2
    return cap
