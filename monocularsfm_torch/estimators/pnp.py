"""Batched PnP (absolute pose from 2D-3D matches) with RANSAC + GN polish.

The port of monocularsfm_tpu/estimators/pnp.py (reference parity:
Registrant::Register wraps cv::solvePnPRansac with P3P/AP3P/EPNP/UPNP,
>= 15 inliers / 4 px / conf 0.9999, Registrant.h:22-27).  Four minimal
solvers, each batched over the hypothesis axis, behind one RANSAC harness:

* "epnp" (the default): 5-point EPnP (Lepetit et al. 2009), barycentric
  coordinates w.r.t. 4 control points, the 12x12 null space from a batched
  eigh, betas for the N=1 and N=2 cases refined by Gauss-Newton on the 6
  control-point distances, pose by Procrustes; both beta cases compete.
* "p3p" / "ap3p": the Grunert quartic on 3 points, roots by Durand-Kerner
  in complex64; up to four poses per sample compete, failed roots give
  non-finite poses that score nothing.  "ap3p" is an alias.
* "p6p": 6-point DLT resection (a 12x12 eigh per hypothesis).
* "upnp": the same DLT with an unknown focal peeled off the row norms, in
  float64 (see estimate_pnp_ransac); each hypothesis is scored with its own
  focal and the winner's polishes.

The DLT solvers keep the reference's unresolved eigenvector sign: a sample
whose null vector comes out negated gives a wrong pose that loses the
scoring pass, so two eigensolvers may pick different winners.  The winner
is polished by Gauss-Newton on its inliers.  The reference takes the 2N x 6
Jacobian with jax.jacfwd; here it is written out by the chain rule through
Rodrigues' formula as `angle_axis_to_matrix` evaluates it, because torch's
forward-mode autodiff imports torch._dynamo at its first use, about 800
modules and 2-10 s on the first registration of every process.
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
    skew,
)
from monocularsfm_torch.utils.linalg import eigh, eigh_vectors, svd
from monocularsfm_torch.utils.precision import mm

_CTRL_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
SAMPLE_SIZE = {"p3p": 3, "ap3p": 3, "epnp": 5, "p6p": 6, "upnp": 6}


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


def _p6p_rows(X: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """DLT resection rows. X: (..., 3) world, xn: (..., 2) normalized image.
    Returns (..., 2, 12) rows of A p = 0 with p = vec(P) row-major."""
    u, v = xn[..., 0:1], xn[..., 1:2]
    Xh = torch.cat([X, torch.ones_like(u)], -1)               # (..., 4)
    z4 = torch.zeros_like(Xh)
    r0 = torch.cat([Xh, z4, -u * Xh], -1)
    r1 = torch.cat([z4, Xh, -v * Xh], -1)
    return torch.stack([r0, r1], -2)


def _dlt_null_vector(Xs: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """P (M, 3, 4) from the smallest eigenvector of AᵀA over 6-point samples
    Xs (M, 6, 3), xs (M, 6, 2); its sign is whatever the eigensolver gives."""
    rows = _p6p_rows(Xs, xs).reshape(Xs.shape[0], -1, 12)     # (M, 12, 12)
    V = eigh_vectors(rows.transpose(-1, -2) @ rows)
    return V[..., :, 0].reshape(-1, 3, 4)


def _project_so3(M: torch.Tensor):
    """Procrustes projection of M (..., 3, 3) onto SO(3), with the mean
    signed singular value as its scale: (R, scale)."""
    U, S, Vh = svd(M)
    d = torch.sign(torch.linalg.det(mm(U, Vh)))
    D = torch.cat([torch.ones_like(S[..., :2]), d[..., None]], -1)
    R = mm(U, D[..., :, None] * Vh)
    scale = (S * D).mean(-1)
    return R, torch.where(scale.abs() < 1e-12, 1e-12, scale)


def _fit_p6p(Xs: torch.Tensor, xs: torch.Tensor):
    """Linear resection on 6-point samples Xs (M, 6, 3), xs (M, 6, 2) ->
    (R (M, 3, 3), t (M, 3))."""
    P = _dlt_null_vector(Xs, xs)
    R, scale = _project_so3(P[..., :3])
    return R, P[..., 3] / scale[..., None]


def _fit_upnp6(Xs: torch.Tensor, uvc: torch.Tensor):
    """Unknown-focal resection from 6-point samples (the UPNP role of
    cv::solvePnPRansac, Registrant.cpp:52-63).  uvc: principal-point-centred
    pixels (M, 6, 2).  Solves the DLT for M = s diag(f, f, 1) [R|t]: s is the
    third row's norm, f the mean of the first two rows' norms over s, and R
    the Procrustes projection of diag(1/f, 1/f, 1) M.  Returns (R (M, 3, 3),
    t (M, 3), f (M,))."""
    P = _dlt_null_vector(Xs, uvc)
    M = P[..., :3]
    s = torch.linalg.norm(M[..., 2, :], dim=-1)
    s = torch.where(s < 1e-12, 1e-12, s)
    f = 0.5 * (torch.linalg.norm(M[..., 0, :], dim=-1)
               + torch.linalg.norm(M[..., 1, :], dim=-1)) / s
    f = torch.where(f < 1e-6, 1e-6, f)
    invK = torch.stack([1.0 / f, 1.0 / f, torch.ones_like(f)], -1)
    R, scale = _project_so3(invK[..., :, None] * M)
    return R, invK * P[..., 3] / scale[..., None], f


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


def _quartic_roots(a3, a2, a1, a0, dk_iters: int = 40, newton_iters: int = 3):
    """All (up to 4) real roots of v^4 + a3 v^3 + a2 v^2 + a1 v + a0, batched
    over the coefficients' shape.

    Durand-Kerner simultaneous iteration in complex64 (branch-free, and
    robust where roots cluster, unlike an f32 Ferrari split), then a few
    Newton steps on the real parts.  A root counts as real where its
    imaginary part is within 1e-3 (1 + |re|).
    Returns (roots (..., 4), valid (..., 4)); float64 coefficients iterate
    in complex128."""
    cdt = torch.complex128 if a3.dtype == torch.float64 else torch.complex64
    c3, c2, c1, c0 = (a.to(cdt)[..., None] for a in (a3, a2, a1, a0))

    def poly(z):
        return (((z + c3) * z + c2) * z + c1) * z + c0

    # Cauchy-bound ring, rotationally asymmetric (0.4+0.9i)^k, k = 1..4; the
    # seed is made on the host so every device starts from the same values.
    bound = 1.0 + torch.maximum(torch.maximum(a3.abs(), a2.abs()),
                                torch.maximum(a1.abs(), a0.abs()))
    seed = torch.tensor(0.4 + 0.9j, dtype=cdt) ** torch.arange(1, 5)
    z = bound[..., None].to(cdt) * seed.to(a3.device)
    eye = torch.eye(4, dtype=cdt, device=a3.device)
    for _ in range(dk_iters):
        diff = z[..., :, None] - z[..., None, :] + eye          # self-diff -> 1
        denom = diff[..., 0] * diff[..., 1] * diff[..., 2] * diff[..., 3]
        denom = torch.where(denom.abs() < 1e-12, 1e-12, denom)
        z = z - poly(z) / denom
    real_ok = z.imag.abs() <= 1e-3 * (1.0 + z.real.abs())
    roots = z.real
    b3, b2, b1, b0 = (a[..., None] for a in (a3, a2, a1, a0))
    for _ in range(newton_iters):
        f = (((roots + b3) * roots + b2) * roots + b1) * roots + b0
        df = ((4.0 * roots + 3.0 * b3) * roots + 2.0 * b2) * roots + b1
        df = torch.where(df.abs() < 1e-12, 1e-12, df)
        roots = roots - f / df
    return roots, real_ok & torch.isfinite(roots)


def _fit_p3p(Xs: torch.Tensor, xs: torch.Tensor):
    """Grunert P3P on 3-point samples Xs (M, 3, 3), xs (M, 3, 2) -> up to
    four candidate poses per sample (Haralick et al. 1994's review of the
    Grunert 1841 formulation), every branch by mask; the candidates compete
    in the ordinary scoring pass, which also makes the 4th-point choice
    cv::solveP3P leaves to its caller.  Returns (R (M, 4, 3, 3), t (M, 4, 3));
    failed roots give non-finite poses, which score no inlier."""
    f = torch.cat([xs, torch.ones_like(xs[..., :1])], -1)
    f = f / torch.linalg.norm(f, dim=-1, keepdim=True)      # unit bearings
    A = ((Xs[:, 1] - Xs[:, 2]) ** 2).sum(-1)                 # a^2 (opposite P1)
    B = ((Xs[:, 0] - Xs[:, 2]) ** 2).sum(-1)                 # b^2
    C = ((Xs[:, 0] - Xs[:, 1]) ** 2).sum(-1)                 # c^2
    p2 = 2.0 * (f[:, 1] * f[:, 2]).sum(-1)                   # 2 cos(alpha)
    q2 = 2.0 * (f[:, 0] * f[:, 2]).sum(-1)                   # 2 cos(beta)
    r2 = 2.0 * (f[:, 0] * f[:, 1]).sum(-1)                   # 2 cos(gamma)

    Bs = torch.where(B.abs() < 1e-12, 1e-12, B)
    k = (A - C) / Bs
    m = C / Bs
    # u = N(v)/D(v) with N = (k-1)v^2 - k q v + (k+1), D = r - p v; the
    # second Grunert equation then gives the quartic
    #   N^2 - r N D + D^2 (1 - m - m v^2 + m q v) = 0.
    n2, n1, n0 = k - 1.0, -k * q2, k + 1.0
    d1, d0 = -p2, r2
    e2, e1, e0 = -m, m * q2, 1.0 - m
    # Polynomial products (coefficients by descending degree).
    nn = (n2 * n2, 2 * n2 * n1, 2 * n2 * n0 + n1 * n1, 2 * n1 * n0, n0 * n0)
    nd = (n2 * d1, n2 * d0 + n1 * d1, n1 * d0 + n0 * d1, n0 * d0)
    dd = (d1 * d1, 2 * d1 * d0, d0 * d0)
    dde = (dd[0] * e2,
           dd[0] * e1 + dd[1] * e2,
           dd[0] * e0 + dd[1] * e1 + dd[2] * e2,
           dd[1] * e0 + dd[2] * e1,
           dd[2] * e0)
    c4 = nn[0] + dde[0]
    c3 = nn[1] - r2 * nd[0] + dde[1]
    c2 = nn[2] - r2 * nd[1] + dde[2]
    c1 = nn[3] - r2 * nd[2] + dde[3]
    c0 = nn[4] - r2 * nd[3] + dde[4]
    c4s = torch.where(c4.abs() < 1e-12, 1e-12, c4)
    v, ok = _quartic_roots(c3 / c4s, c2 / c4s, c1 / c4s, c0 / c4s)  # (M, 4)

    # Every root at once: the last axis of 4 is the reference's vmap.
    k, q2, p2, r2, B = (a[:, None] for a in (k, q2, p2, r2, B))
    D = r2 - p2 * v
    Ds = torch.where(D.abs() < 1e-9, 1e-9, D)
    u = ((k - 1.0) * v * v - k * q2 * v + (k + 1.0)) / Ds
    denom = 1.0 + v * v - q2 * v
    denom = torch.where(denom.abs() < 1e-12, 1e-12, denom)
    s1 = torch.sqrt(torch.clamp(B / denom, min=0.0))
    s = torch.stack([s1, u * s1, v * s1], -1)                # (M, 4, 3)
    ok = ok & (s > 1e-9).all(-1)
    pc = s[..., None] * f[:, None]                           # (M, 4, 3, 3)
    # A failed root's points are replaced by the world points before the
    # SVD (which may reject non-finite input); its pose is NaN all the same.
    Xw = Xs[:, None].expand_as(pc)
    R, t = _procrustes_pose(Xw, torch.where(ok[..., None, None], pc, Xw))
    nan = torch.tensor(float("nan"), dtype=R.dtype, device=R.device)
    return (torch.where(ok[..., None, None], R, nan),
            torch.where(ok[..., None], t, nan))


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


def _polish_residuals(params, K, X, uv, w):
    """The weighted pixel residuals (2N,) of the pose `params` (angle-axis,
    t) and their Jacobian (2N, 6), rows (u, v) a point.  The Jacobian is
    the derivative of the residuals as computed here, `angle_axis_to_matrix`
    with its small-angle branch and the clamp of z included."""
    a = params[:3]
    theta2 = (a * a).sum()
    theta = torch.sqrt(theta2 + 1e-12)
    small = theta2 < 1e-8
    sin, cos = torch.sin(theta), torch.cos(theta)
    # sinc = sin(theta) / theta and cosc = (1 - cos(theta)) / theta2, and
    # their derivatives with respect to theta2.
    sinc = torch.where(small, 1.0 - theta2 / 6.0, sin / theta)
    cosc = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - cos) / theta2)
    dsinc = torch.where(small, -1.0 / 6.0,
                        (theta * cos - sin) / (2.0 * theta ** 3))
    dcosc = torch.where(small, -1.0 / 24.0,
                        sin / (2.0 * theta * theta2) - (1.0 - cos) / theta2 ** 2)
    Ka = skew(a)
    xc = X @ angle_axis_to_matrix(a[None])[0].T + params[3:]
    # d(R X) / da: R X = X + sinc a x X + cosc a x (a x X).
    aX = torch.linalg.cross(a.expand_as(X), X)
    aaX = torch.linalg.cross(a.expand_as(X), aX)
    sX = skew(X)
    dRX = (2.0 * a * (dsinc * aX[:, :, None] + dcosc * aaX[:, :, None])
           - sinc * sX - cosc * (skew(aX) + Ka @ sX))             # (N, 3, 3)
    clamped = xc[:, 2].abs() < 1e-6
    z = torch.where(clamped, 1e-6, xc[:, 2])
    fx, fy = K[0, 0], K[1, 1]
    r = torch.stack([fx * xc[:, 0] / z + K[0, 2] - uv[:, 0],
                     fy * xc[:, 1] / z + K[1, 2] - uv[:, 1]], -1) * w[:, None]
    # d r / d xc, (N, 2, 3); a clamped z is a constant.
    dz = torch.where(clamped, 0.0, -1.0 / (z * z))
    zero = torch.zeros_like(z)
    dr = torch.stack([torch.stack([fx / z, zero, fx * xc[:, 0] * dz], -1),
                      torch.stack([zero, fy / z, fy * xc[:, 1] * dz], -1)], -2)
    dr = dr * w[:, None, None]
    J = torch.cat([dr @ dRX, dr], -1)
    return r.reshape(-1), J.reshape(-1, 6)


def estimate_pnp_ransac(u: torch.Tensor, K: torch.Tensor, X: torch.Tensor,
                        uv: torch.Tensor, mask: torch.Tensor,
                        threshold_px: float = 4.0, refine_iters: int = 10,
                        method: str = "p6p"):
    """RANSAC PnP (minimal solver per `method`) + Gauss-Newton polish.

    u: (M, N) uniform draws (M samples), K: (3, 3), X: (N, 3) world points,
    uv: (N, 2) pixels, mask: (N,) validity.  method: "epnp" (two models per
    sample) | "p3p" or "ap3p" (up to four) | "p6p" | "upnp" (one each).
    Returns a dict of R, t, angle_axis, inliers, num_inliers, success,
    mean_inlier_error_px and focal (K's, or the winner's for "upnp")."""
    if method not in SAMPLE_SIZE:
        raise ValueError(f"unknown pnp method {method!r}")
    K = K.float()
    X = X.float()
    uv = uv.float()
    fx, fy = K[0, 0], K[1, 1]
    xn = torch.stack([(uv[:, 0] - K[0, 2]) / fx, (uv[:, 1] - K[1, 2]) / fy], -1)
    thr2 = float(np.float32(threshold_px) ** 2)

    sets = sample_minimal_sets(u, SAMPLE_SIZE[method], mask)  # (M, k)
    if method == "upnp":
        # Unknown-focal resection: each hypothesis is scored with its own
        # focal; the winner's focal replaces K's for the polish.  (The
        # reference's EPNP enum also dispatches cv::SOLVEPNP_UPNP, which
        # OpenCV >= 3.3 runs as EPnP; "upnp" is what the enum advertises.)
        # The DLT runs in float64: on pixel-scale coordinates f32 AᵀA leaves
        # the null vector to the eigensolver's rounding (a hypothesis's
        # focal ~4% off at the median with LAPACK, ~27% with the card's
        # batched Jacobi solver, where RANSAC can miss the 5% bound of the
        # JAX package's own test); in float64 both devices solve it exactly.
        uvc = torch.stack([uv[:, 0] - K[0, 2], uv[:, 1] - K[1, 2]], -1)
        R, t, f_hyp = (a.float() for a in _fit_upnp6(X[sets].double(),
                                                     uvc[sets].double()))
        xc = X @ R.transpose(-1, -2) + t[:, None, :]          # (M, N, 3)
        z = xc[..., 2]
        zs = torch.where(z.abs() < 1e-6, 1e-6, z)
        pu = f_hyp[:, None] * xc[..., 0] / zs + K[0, 2]
        pv = f_hyp[:, None] * xc[..., 1] / zs + K[1, 2]
        err2 = (pu - uv[None, :, 0]) ** 2 + (pv - uv[None, :, 1]) ** 2
        err2 = torch.where(z <= 1e-6, 1e18, err2)
        del xc, z, zs, pu, pv
        best, inl_best, _ = score_hypotheses(err2, mask, thr2)
        fx = fy = f_hyp[best]
        K = K.clone()
        K[0, 0] = fx
        K[1, 1] = fy
    else:
        fit = {"epnp": _fit_epnp5, "p3p": _fit_p3p, "ap3p": _fit_p3p,
               "p6p": _fit_p6p}[method]
        # AP3P (Ke & Roumeliotis 2017) reaches the same up-to-4 solution
        # set as Grunert's P3P; one solver serves both enum values.
        R, t = fit(X[sets], xn[sets])
        R = R.reshape(-1, 3, 3)   # every model of every sample competes
        t = t.reshape(-1, 3)
        err2 = _reproj_err_px(K, R, t, X[None], uv[None])      # (models, N)
        best, inl_best, _ = score_hypotheses(err2, mask, thr2)
    del err2
    R_best, t_best = R[best], t[best]

    eye6 = torch.eye(6, dtype=K.dtype, device=K.device)
    params = torch.cat([matrix_to_angle_axis(R_best), t_best])
    for _ in range(refine_iters):
        w = ((_reproj_err_px(K, angle_axis_to_matrix(params[:3]), params[3:],
                             X, uv) <= thr2) & mask).float()
        r, J = _polish_residuals(params, K, X, uv, w)         # (2N,), (2N, 6)
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
        "angle_axis": matrix_to_angle_axis(R_fin),
        "inliers": inliers,
        "num_inliers": num_inl,
        "success": num_inl >= 6,
        "mean_inlier_error_px": mean_err,
        "focal": K[0, 0],
    }
