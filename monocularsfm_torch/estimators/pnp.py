"""Batched EPnP (absolute pose from 2D-3D matches) with RANSAC + GN polish.

The port of the default `pnp_method="epnp"` of
monocularsfm_tpu/estimators/pnp.py (reference parity: Registrant::Register
wraps cv::solvePnPRansac, >= 15 inliers / 4 px / conf 0.9999,
Registrant.h:22-27).  Every hypothesis is a 5-point EPnP sample (Lepetit et
al. 2009): barycentric coordinates w.r.t. 4 control points, the 12x12
null space from a batched eigh, betas for the N=1 and N=2 cases refined by
Gauss-Newton on the 6 control-point distances, pose by Procrustes.  Both
beta cases of every sample compete in one scoring pass.  The winner is
polished by Gauss-Newton on its inliers; the 2N x 6 Jacobian is taken by
forward-mode autodiff (torch.func.jacfwd), as the reference takes it with
jax.jacfwd.  The other methods (p3p, ap3p, p6p, upnp) are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from monocularsfm_torch.estimators.ransac import (
    sample_minimal_sets,
    score_hypotheses,
)
from monocularsfm_torch.geometry.rotations import (
    angle_axis_to_matrix,
    matrix_to_angle_axis,
)
from monocularsfm_torch.utils.linalg import eigh, eigh_vectors, svd
from monocularsfm_torch.utils.precision import mm

_CTRL_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
SAMPLE_SIZE = {"epnp": 5}


def _solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched solve without the singularity check (a singular system gives
    non-finite values, as jnp.linalg.solve does, and no host sync)."""
    return torch.linalg.solve_ex(A, b[..., None], check_errors=False)[0][..., 0]


def _procrustes_pose(Xw: torch.Tensor, Xc: torch.Tensor):
    """Rigid R, t with R @ Xw + t ~= Xc (Horn's method). Xw/Xc: (..., n, 3)."""
    cw = Xw.mean(-2)
    cc = Xc.mean(-2)
    H = (Xw - cw[..., None, :]).transpose(-1, -2) @ (Xc - cc[..., None, :])
    U, _, Vh = svd(H)
    d = torch.sign(torch.linalg.det(mm(Vh.transpose(-1, -2), U.transpose(-1, -2))))
    D = torch.ones(H.shape[:-1], dtype=H.dtype, device=H.device)
    D = torch.cat([D[..., :2], d[..., None]], dim=-1)
    R = mm(Vh.transpose(-1, -2), D[..., :, None] * U.transpose(-1, -2))
    t = cc - (R @ cw[..., None])[..., 0]
    return R, t


def _fit_epnp5(Xs: torch.Tensor, xs: torch.Tensor):
    """EPnP on 5-point samples -> two candidate (R, t) models per sample
    (beta cases N=1 and N=2, each Gauss-Newton-refined on the distance
    constraints).  Xs: (M, 5, 3) world, xs: (M, 5, 2) normalized.
    Returns (R (M, 2, 3, 3), t (M, 2, 3))."""
    M, npts = Xs.shape[:2]
    dt, dev = Xs.dtype, Xs.device
    c0 = Xs.mean(1)                                           # (M, 3)
    A = Xs - c0[:, None]
    lam, v = eigh(A.transpose(-1, -2) @ A)                    # ascending
    s = torch.sqrt(torch.clamp(lam, min=1e-10) / npts)
    ctrl = torch.cat([c0[:, None], c0[:, None] + s[..., None] * v.transpose(-1, -2)], 1)

    # Barycentric coordinates of the sample points w.r.t. the control points.
    ones4 = torch.ones((M, 1, 4), dtype=dt, device=dev)
    Ch = torch.cat([ctrl.transpose(-1, -2), ones4], 1)
    Ch = Ch + 1e-10 * torch.eye(4, dtype=dt, device=dev)
    Xh = torch.cat([Xs, torch.ones((M, npts, 1), dtype=dt, device=dev)], -1)
    alphas = torch.linalg.solve_ex(Ch, Xh.transpose(-1, -2),
                                   check_errors=False)[0].transpose(-1, -2)

    # M x = 0 over camera-frame control-point coordinates x (12,).
    u, w = xs[..., 0:1], xs[..., 1:2]
    zero = torch.zeros_like(alphas)
    ru = torch.stack([alphas, zero, -alphas * u], -1).reshape(M, npts, 12)
    rv = torch.stack([zero, alphas, -alphas * w], -1).reshape(M, npts, 12)
    Mm = torch.cat([ru, rv], 1)                               # (M, 2n, 12)
    V = eigh_vectors(Mm.transpose(-1, -2) @ Mm)
    vk = V[..., :2].transpose(-1, -2).reshape(M, 2, 4, 3)     # two smallest

    ii = [p[0] for p in _CTRL_PAIRS]
    jj = [p[1] for p in _CTRL_PAIRS]
    dw2 = ((ctrl[:, ii] - ctrl[:, jj]) ** 2).sum(-1)          # (M, 6)
    dv = vk[:, :, ii] - vk[:, :, jj]                          # (M, 2, 6, 3)

    # Case N=1: scale of v1 alone (least squares on distances).
    n1 = torch.sqrt(torch.clamp((dv[:, 0] ** 2).sum(-1), min=1e-12))
    beta_c1 = (n1 * torch.sqrt(dw2)).sum(-1) / torch.clamp((n1 ** 2).sum(-1), min=1e-12)
    betas1 = torch.stack([beta_c1, torch.zeros_like(beta_c1)], -1)

    # Case N=2: solve [b1^2, b1 b2, b2^2] from the 6 linear constraints.
    d11 = (dv[:, 0] * dv[:, 0]).sum(-1)
    d12 = (dv[:, 0] * dv[:, 1]).sum(-1)
    d22 = (dv[:, 1] * dv[:, 1]).sum(-1)
    L = torch.stack([d11, 2.0 * d12, d22], -1)                # (M, 6, 3)
    LtL = L.transpose(-1, -2) @ L + 1e-10 * torch.eye(3, dtype=dt, device=dev)
    b = _solve(LtL, (L.transpose(-1, -2) @ dw2[..., None])[..., 0])
    betas2 = torch.stack([torch.sqrt(b[:, 0].abs()),
                          torch.sign(b[:, 1]) * torch.sqrt(b[:, 2].abs())], -1)

    eye2 = 1e-8 * torch.eye(2, dtype=dt, device=dev)

    def gn_refine(bs):
        # Minimise sum_p (||sum_k beta_k dv_k||^2 - dw2_p)^2 over the betas.
        for _ in range(5):
            diff = torch.einsum("mk,mkpi->mpi", bs, dv)       # (M, 6, 3)
            r = (diff ** 2).sum(-1) - dw2
            J = 2.0 * torch.einsum("mpi,mkpi->mpk", diff, dv)  # (M, 6, 2)
            JtJ = J.transpose(-1, -2) @ J + eye2
            new = bs - _solve(JtJ, (J.transpose(-1, -2) @ r[..., None])[..., 0])
            bs = torch.where(torch.isfinite(new).all(-1, keepdim=True), new, bs)
        return bs

    def pose_from_betas(bs):
        cc = torch.einsum("mk,mkij->mij", bs, vk)             # (M, 4, 3)
        pc = alphas @ cc                                      # (M, 5, 3)
        flip = torch.where(pc[..., 2].mean(-1) < 0.0, -1.0, 1.0)
        return _procrustes_pose(Xs, pc * flip[:, None, None])

    R1, t1 = pose_from_betas(gn_refine(betas1))
    R2, t2 = pose_from_betas(gn_refine(betas2))
    return torch.stack([R1, R2], 1), torch.stack([t1, t2], 1)


def _reproj_err_px(K, R, t, X, uv):
    """Squared pixel error of (..., N) points under poses (..., 3, 3);
    points behind the camera get 1e18 (never inliers)."""
    xc = X @ R.transpose(-1, -2) + t[..., None, :]
    z = xc[..., 2]
    behind = z <= 1e-6
    zs = torch.where(z.abs() < 1e-6, 1e-6, z)
    u = K[0, 0] * xc[..., 0] / zs + K[0, 2]
    v = K[1, 1] * xc[..., 1] / zs + K[1, 2]
    err2 = (u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2
    return torch.where(behind, 1e18, err2)


def estimate_pnp_ransac(u: torch.Tensor, K: torch.Tensor, X: torch.Tensor,
                        uv: torch.Tensor, mask: torch.Tensor,
                        threshold_px: float = 4.0, refine_iters: int = 10,
                        method: str = "epnp"):
    """RANSAC PnP + Gauss-Newton polish.

    u: (M, N) uniform draws (M hypotheses, two models each), K: (3, 3),
    X: (N, 3) world points, uv: (N, 2) pixels, mask: (N,) validity.
    Returns a dict of R, t, inliers, num_inliers, success and
    mean_inlier_error_px."""
    if method != "epnp":
        raise NotImplementedError(
            f"pnp_method {method!r} is not ported; the port has 'epnp'")
    K = K.float()
    X = X.float()
    uv = uv.float()
    fx, fy = K[0, 0], K[1, 1]
    xn = torch.stack([(uv[:, 0] - K[0, 2]) / fx, (uv[:, 1] - K[1, 2]) / fy], -1)
    thr2 = float(np.float32(threshold_px) ** 2)

    sets = sample_minimal_sets(u, 5, mask)                    # (M, 5)
    R, t = _fit_epnp5(X[sets], xn[sets])
    R = R.reshape(-1, 3, 3)   # (2M, 3, 3): both beta cases compete
    t = t.reshape(-1, 3)
    err2 = _reproj_err_px(K, R, t, X[None], uv[None])          # (2M, N)
    best, inl_best, _ = score_hypotheses(err2, mask, thr2)
    del err2
    R_best, t_best = R[best], t[best]

    def residuals(params, w):
        # (1, 3) angle-axis: under jacfwd a 0-dim intermediate would promote
        # python-float arithmetic to float64.
        Rp = angle_axis_to_matrix(params[None, :3])[0]
        xc = X @ Rp.T + params[3:]
        z = torch.where(xc[:, 2].abs() < 1e-6, 1e-6, xc[:, 2])
        ru = fx * xc[:, 0] / z + K[0, 2] - uv[:, 0]
        rv = fy * xc[:, 1] / z + K[1, 2] - uv[:, 1]
        return (torch.stack([ru, rv], -1) * w[:, None]).reshape(-1)

    jac = torch.func.jacfwd(residuals)
    eye6 = torch.eye(6, dtype=K.dtype, device=K.device)
    params = torch.cat([matrix_to_angle_axis(R_best), t_best])
    for _ in range(refine_iters):
        w = ((_reproj_err_px(K, angle_axis_to_matrix(params[:3]), params[3:],
                             X, uv) <= thr2) & mask).float()
        J = jac(params, w)                                    # (2N, 6)
        r = residuals(params, w)
        JtJ = J.T @ J
        Jtr = J.T @ r
        damp = 1e-6 * torch.trace(JtJ) / 6.0
        new = params - _solve(JtJ + damp * eye6, Jtr)
        params = torch.where(torch.isfinite(new).all(), new, params)
    R_fin = angle_axis_to_matrix(params[:3])
    t_fin = params[3:]
    err2_fin = _reproj_err_px(K, R_fin, t_fin, X, uv)
    num_inl = ((err2_fin <= thr2) & mask).sum()
    # Fall back to the unpolished winner if GN diverged.
    better = num_inl >= inl_best.sum()
    R_fin = torch.where(better, R_fin, R_best)
    t_fin = torch.where(better, t_fin, t_best)
    err2_fin = torch.where(better, err2_fin, _reproj_err_px(K, R_best, t_best, X, uv))
    inliers = (err2_fin <= thr2) & mask
    num_inl = inliers.sum()
    mean_err = torch.sqrt(torch.where(inliers, err2_fin, 0.0).sum()
                          / torch.clamp(num_inl, min=1))
    return {
        "R": R_fin,
        "t": t_fin,
        "inliers": inliers,
        "num_inliers": num_inl,
        "success": num_inl >= 6,
        "mean_inlier_error_px": mean_err,
    }
