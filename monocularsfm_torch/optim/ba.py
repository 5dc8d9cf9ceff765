"""Levenberg-Marquardt bundle adjustment with the Schur complement.

The port of monocularsfm_tpu/optim/ba.py (reference parity:
src/Optimizer/CeresBundleOptimizer.cpp — residual: angle-axis rotate +
translate + pinhole f*x/z against pre-undistorted observations, :29-53;
solver: DENSE_SCHUR for small bundles, iterative beyond, :262-291; gauge:
constant poses pinned, :256-260).

Same algorithm as the reference, written as plain tensor code:

* Pose increments live in a left-multiplicative local frame,
  R <- exp([dw]_x) R, t <- t + dt, so the rotation Jacobian is -[R X]_x.
* Observations sit in a (rows, T) layout; `point_rows` maps rows to points
  when long tracks are split across rows (None = one row per point).
  The solve works on the flat list of weighted observations: Jacobian
  blocks are plain (obs, 2, 6) / (obs, 2, 3) tensors, and camera and point
  sums are segment sums over their camera and point indices
  (utils/segment.py: in a fixed order on the card, as the reference's
  `segment_sum`, so one input gives one result).
* `solve_mode="dense"` builds the reduced camera system
  S = U~ - sum_p Y_p W_p^T densely (a chunked one-hot matmul over points)
  and solves it by a Jacobi-equilibrated Cholesky.  With `refine_focal`
  two shared (fx, fy) columns ride in the same system.  A Cholesky that
  fails turns the step into NaN, which the LM accept test rejects.
* `solve_mode="pcg"` caches the coupling blocks W = Jc^T Jp once per LM
  iteration and runs block-Jacobi preconditioned CG on S matrix-free,
  stopping at ||r|| <= pcg_rtol ||rhs|| or `pcg_iters` steps (the
  reference's cached-block path).  Its point sums are segment sums over
  point indices, so `point_rows` may come in any order (the reference
  routes unsorted rows to its flash path, which solves the same system).
* The trust-region loop is classic LM radius control as in Ceres.  The
  reference runs it, and CG, as device while-loops; here the host reads
  the LM exit flag once per LM iteration and the CG exit test once per CG
  step (one device sync each), so iteration counts follow the same rules.
  As in the reference, the loop may run in segments (`dispatch_iters`),
  each resuming from the state (K, R, t, X, radius, cost, iterations,
  converged) the last one ended in (`init_state`).
* With a process `group` the solve is SPMD over a landmark-sharded problem
  (parallel/distributed_ba.py): each rank holds a slab of points and their
  observations, the cameras are replicated, and the camera-side sums (U,
  g_c, the Schur system and its rhs, every cost, the predicted reduction)
  are all-reduced over the group, as the reference's psum sites do.  The
  replicated camera solve then runs identically on every rank, the point
  back-substitution stays local, and every branch (LM accept, stop, the CG
  test) reads only reduced or replicated values, so the ranks stay in step.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from monocularsfm_torch.geometry.rotations import angle_axis_to_matrix, skew
from monocularsfm_torch.utils.segment import segment_plan, segment_sum


@dataclasses.dataclass
class BundleProblem:
    """Fixed-shape BA problem (the reference's BundleData, SoA edition).

    C = camera capacity, P = point capacity, T = track width,
    Pr = observation-row capacity (= P unless long tracks are split)."""

    K: torch.Tensor            # (4,) fx, fy, cx, cy
    R: torch.Tensor            # (C, 3, 3) world->camera
    t: torch.Tensor            # (C, 3)
    X: torch.Tensor            # (P, 3)
    cam_valid: torch.Tensor    # (C,) bool
    cam_const: torch.Tensor    # (C,) bool — gauge-pinned poses
    point_valid: torch.Tensor  # (P,) bool
    obs_cam: torch.Tensor      # (Pr, T) int64 camera index (0 where invalid)
    obs_uv: torch.Tensor       # (Pr, T, 2) pixel observations
    obs_valid: torch.Tensor    # (Pr, T) bool
    # Row -> point index map for tracks longer than T (None = identity,
    # which the dense solver requires).
    point_rows: torch.Tensor | None = None  # (Pr,) int64 or None

    def tensors(self) -> dict[str, torch.Tensor]:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None}

    def to(self, device) -> "BundleProblem":
        return dataclasses.replace(
            self, **{k: v.to(device) for k, v in self.tensors().items()})


def make_bundle_problem(
    K4, R, t, X, obs_cam, obs_uv, obs_valid, cam_const,
    cam_valid=None, point_valid=None, point_rows=None,
) -> BundleProblem:
    """Assemble a BundleProblem on the CPU from host arrays (no padding
    logic here); `BundleProblem.to` moves it."""
    C = np.asarray(R).shape[0]
    if cam_valid is None:
        cam_valid = np.ones(C, bool)
    if point_valid is None:
        assert point_rows is None, "point_valid required with split rows"
        point_valid = np.asarray(obs_valid).any(axis=1)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    def i64(a):
        return torch.as_tensor(np.asarray(a, np.int64))

    def bool_(a):
        return torch.as_tensor(np.asarray(a, bool))

    return BundleProblem(
        K=f32(K4), R=f32(R), t=f32(t), X=f32(X),
        cam_valid=bool_(cam_valid), cam_const=bool_(cam_const),
        point_valid=bool_(point_valid), obs_cam=i64(obs_cam),
        obs_uv=f32(obs_uv), obs_valid=bool_(obs_valid),
        point_rows=None if point_rows is None else i64(point_rows),
    )


def _inv3x3(a: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    det = a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02
    det = torch.where(det.abs() < 1e-18, 1e-18, det)
    adj = torch.stack([
        torch.stack([c00, c10, c20], -1),
        torch.stack([c01, c11, c21], -1),
        torch.stack([c02, c12, c22], -1),
    ], dim=-2)
    return adj / det[..., None, None]


# The per-observation blocks are tiny (2x6, 6x3, 3x3) and number up to
# millions: cuBLAS's batched gemm/gemv runs them at a small fraction of
# memory bandwidth, so they are products of broadcasts and sums.
def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (..., m, n) x (..., n) -> (..., m)."""
    return (M * v[..., None, :]).sum(-1)


def _mm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched product of small matrices (..., m, k) x (..., k, n)."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def _tmm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched A^T B of small matrices (..., k, m), (..., k, n) -> (..., m, n)."""
    return (A[..., :, :, None] * B[..., :, None, :]).sum(-3)


# Points per one-hot matmul of the dense Schur build (the default of the
# `schur_chunk` keyword).
_SCHUR_CHUNK = 2048
# The reference's default capacities of its cached-PCG layout.
_PCG_DEFAULT_MAX_ROWS = 1
_PCG_DEFAULT_MAX_BLOCKS = 16


def _check_device(prob: BundleProblem, device) -> torch.device:
    """The device the solve runs on; refuses a problem that lies elsewhere."""
    if device is None:
        return prob.R.device
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    for name, v in prob.tensors().items():
        if v.device != dev:
            raise ValueError(
                f"bundle_adjust on {dev}: BundleProblem.{name} lies on "
                f"{v.device}; move the problem with prob.to({str(dev)!r})")
    return dev


def _next_pow2(x: int, minimum: int = 1) -> int:
    cap = minimum
    while cap < x:
        cap *= 2
    return cap


def _pcg_capacities(prob: BundleProblem) -> dict[str, int]:
    """The reference's cached-PCG capacities for this problem
    (derive_pcg_cached_statics): the most rows of one point and the most
    128-observation blocks of one camera, each rounded up to a power of
    two; {} when `point_rows` is unsorted, which that layout cannot take."""
    obs_cam = prob.obs_cam.cpu().numpy()
    obs_valid = prob.obs_valid.cpu().numpy()
    max_rows = 1
    if prob.point_rows is not None:
        r = prob.point_rows.cpu().numpy()
        if np.any(np.diff(r) < 0):
            return {}
        real = obs_valid.any(axis=1)
        if real.any():
            max_rows = int(np.bincount(r[real]).max())
    used = obs_cam[obs_valid]
    per_cam = (int(np.bincount(used, minlength=prob.R.shape[0]).max())
               if used.size else 1)
    return {"pcg_max_rows": _next_pow2(max_rows),
            "pcg_max_blocks": _next_pow2(-(-per_cam // 128))}


def bundle_adjust(
    prob: BundleProblem,
    max_iterations: int = 50,
    device=None,
    function_tolerance: float = 1e-6,
    parameter_tolerance: float = 1e-8,
    gradient_tolerance: float = 1e-10,
    initial_radius: float = 1e4,
    solve_mode: str = "dense",
    pcg_iters: int = 100,
    refine_focal: bool = False,
    min_lm_diagonal: float = 1e-6,
    max_lm_diagonal: float = 1e32,
    pcg_rtol: float = 1e-2,
    group=None,
    dispatch_iters: int | None = None,
    init_state=None,
    schur_chunk: int = _SCHUR_CHUNK,
    pcg_cached: bool = False,
    pcg_max_rows: int | None = None,
    pcg_max_blocks: int | None = None,
) -> dict[str, Any]:
    """Run LM on `device` (default: where the problem lies).

    With `group` (a torch.distributed process group) every rank of it calls
    this with its slab of points and the same cameras; the results hold the
    rank's slab of X and the replicated rest.

    `dispatch_iters` runs the solve in segments of at most that many LM
    iterations, each resuming from the state the last one ended in, until
    `max_iterations` or convergence; None runs one segment.  The reference
    sizes its segments from a wall-time model so that one device dispatch
    stays inside a TPU worker's execution grant; the iterates do not depend
    on the segments, so neither does the result.  `init_state`, the tuple
    (K, R, t, X, radius, cost, iterations, converged) of an earlier
    result, resumes a solve (X is this rank's slab under a group).

    `schur_chunk` is the number of points per one-hot product of the dense
    Schur build.  `pcg_cached`, `pcg_max_rows` and `pcg_max_blocks` are the
    reference's cached-PCG layout: this solver has no static capacities,
    so they change nothing, but they are refused where the reference
    refuses them (unsorted `point_rows`, capacities below the problem's).

    Returns a dict of R, t, X, K, cost_initial, cost_final, rmse_initial,
    rmse_final (per residual component), mean_reproj_error (per
    observation), num_residuals, radius (tensors), iterations (int),
    converged (bool) and cg_steps (int, the PCG solver's CG steps in all).
    cost_initial and rmse_initial are those of the first segment."""
    if pcg_cached:
        need = _pcg_capacities(prob)
        if not need:
            raise ValueError("pcg_cached=True requires sorted point_rows")
        for k, have in (("pcg_max_rows", pcg_max_rows),
                        ("pcg_max_blocks", pcg_max_blocks)):
            if have is None:
                have = {"pcg_max_rows": _PCG_DEFAULT_MAX_ROWS,
                        "pcg_max_blocks": _PCG_DEFAULT_MAX_BLOCKS}[k]
            if have < need[k]:
                raise ValueError(
                    f"{k}={have} too small for this problem (needs "
                    f">= {need[k]}); pass none to derive automatically")
    if dispatch_iters is not None and dispatch_iters < 1:
        raise ValueError(f"dispatch_iters must be >= 1, got {dispatch_iters}")
    kw = dict(device=device, function_tolerance=function_tolerance,
              parameter_tolerance=parameter_tolerance,
              gradient_tolerance=gradient_tolerance,
              initial_radius=initial_radius, solve_mode=solve_mode,
              pcg_iters=pcg_iters, refine_focal=refine_focal,
              min_lm_diagonal=min_lm_diagonal, max_lm_diagonal=max_lm_diagonal,
              pcg_rtol=pcg_rtol, group=group, schur_chunk=schur_chunk)
    state, first, cg_steps = init_state, None, 0
    while True:
        if dispatch_iters is None:
            limit = max_iterations
        else:
            start = 0 if state is None else int(state[6])
            limit = min(start + dispatch_iters, max_iterations)
        out = _lm_segment(prob, limit, state, **kw)
        cg_steps += out["cg_steps"]
        if first is None:
            first = out
        if out["iterations"] >= max_iterations or out["converged"]:
            break
        state = tuple(out[k] for k in ("K", "R", "t", "X", "radius",
                                       "cost_final", "iterations", "converged"))
    out.update(cost_initial=first["cost_initial"],
               rmse_initial=first["rmse_initial"], cg_steps=cg_steps)
    return out


def _lm_segment(
    prob: BundleProblem,
    max_iterations: int,
    init_state,
    device,
    function_tolerance: float,
    parameter_tolerance: float,
    gradient_tolerance: float,
    initial_radius: float,
    solve_mode: str,
    pcg_iters: int,
    refine_focal: bool,
    min_lm_diagonal: float,
    max_lm_diagonal: float,
    pcg_rtol: float,
    group,
    schur_chunk: int,
) -> dict[str, Any]:
    """LM iterations until the absolute iteration count `max_iterations` or
    convergence, from `init_state` or, when it is None, from the problem's
    state at `initial_radius`."""
    _check_device(prob, device)
    if solve_mode not in ("dense", "pcg"):
        raise ValueError(f"unknown solve_mode {solve_mode!r}")
    if refine_focal and solve_mode != "dense":
        raise ValueError("refine_focal requires solve_mode='dense'")
    rows = prob.point_rows
    if rows is not None and group is not None:
        raise ValueError("distributed BA requires the identity point_rows map")
    if rows is not None and solve_mode == "dense":
        raise ValueError(
            "dense Schur requires the identity point_rows map (one row per "
            "point); build the problem unsplit or use solve_mode='pcg'")

    f32 = torch.float32
    dev = prob.R.device
    if group is None:
        def psum(*ts):
            return ts

        def pmax(t):
            return t
    else:
        from monocularsfm_torch.parallel.mesh import all_reduce, all_reduce_sum

        def psum(*ts):
            return all_reduce_sum(ts, group)

        def pmax(t):
            return all_reduce(t, "max", group)
    C = prob.R.shape[0]
    P, T = prob.obs_cam.shape      # observation-row capacity, track width
    Pn = prob.X.shape[0]           # point capacity (== P when rows is None)
    row_pt = torch.arange(P, device=dev) if rows is None else rows
    cam_all = prob.obs_cam.reshape(-1)
    pt_all = row_pt[:, None].expand(P, T).reshape(-1)
    # Only observations of valid points in valid cameras carry weight (the
    # reference multiplies the rest by 0).  They are selected once (one host
    # sync for their count), so no per-observation pass touches padding and
    # no reduction piles padding's zeros onto camera 0.  The plans of the
    # camera and point sums are built from them once per solve.
    obs = (prob.obs_valid.reshape(-1) & prob.point_valid[pt_all]
           & prob.cam_valid[cam_all]).nonzero()[:, 0]     # (O,)
    cam_o, pt_o = cam_all[obs], pt_all[obs]
    cam_plan, pt_plan = segment_plan(cam_o, C), segment_plan(pt_o, Pn)
    uv_o = prob.obs_uv.reshape(-1, 2)[obs]
    num_res = torch.tensor(float(obs.numel()), device=dev)  # this rank's
    free_cam = (prob.cam_valid & ~prob.cam_const).to(f32)  # (C,)
    pin = ~(prob.cam_valid & ~prob.cam_const)
    pv = prob.point_valid.to(f32)
    eye3 = torch.eye(3, dtype=f32, device=dev)
    eye6 = torch.eye(6, dtype=f32, device=dev)

    def to_cams(vals):
        return segment_sum(vals, cam_plan)

    def to_points(vals):
        return segment_sum(vals, pt_plan)

    def project(K, R, t, X):
        """Per-observation q = R X, p = q + t, clamped depth, residual."""
        R_o = R[cam_o]                                     # (O, 3, 3)
        q = _mv(R_o, X[pt_o])
        p = q + t[cam_o]
        zs = torch.where(p[:, 2].abs() < 1e-6, 1e-6, p[:, 2])
        ru = K[0] * p[:, 0] / zs + K[2] - uv_o[:, 0]
        rv = K[1] * p[:, 1] / zs + K[3] - uv_o[:, 1]
        return torch.stack([ru, rv], -1), q, p, zs, R_o

    def cost_of(K, R, t, X):
        """This rank's part of the cost (all of it without a group)."""
        r = project(K, R, t, X)[0]
        return 0.5 * (r * r).sum()

    def linearize(K, R, t, X):
        """Residuals and Jacobian blocks at the current state."""
        r, q, p, zs, R_o = project(K, R, t, X)
        inv_z = 1.0 / zs
        zero = torch.zeros_like(zs)
        Jproj = torch.stack([
            torch.stack([K[0] * inv_z, zero, -K[0] * p[:, 0] * inv_z * inv_z], -1),
            torch.stack([zero, K[1] * inv_z, -K[1] * p[:, 1] * inv_z * inv_z], -1),
        ], dim=-2)                                          # (O, 2, 3)
        Jpose = torch.cat([-skew(q), eye3.expand(q.shape[0], 3, 3)], -1)
        Jc = _mm(Jproj, Jpose) * free_cam[cam_o][:, None, None]  # (O, 2, 6)
        Jp = _mm(Jproj, R_o)                                # (O, 2, 3)
        return r, Jc, Jp, p, inv_z

    def damp(U, V, lam):
        """Ceres-style diagonal damping with clamped diagonals; pinned
        cameras and invalid points get identity blocks (zero step)."""
        dU = torch.clamp(torch.diagonal(U, dim1=-2, dim2=-1),
                         min_lm_diagonal, max_lm_diagonal)
        dV = torch.clamp(torch.diagonal(V, dim1=-2, dim2=-1),
                         min_lm_diagonal, max_lm_diagonal)
        U_d = torch.where(pin[:, None, None], eye6, U + torch.diag_embed(lam * dU))
        V_d = torch.where(prob.point_valid[:, None, None], V + torch.diag_embed(lam * dV), eye3)
        return U_d, V_d

    def gradient_inf(g_c, g_p):
        """Max-norm of the gradient: g_c is already reduced, the point
        side is the max over the ranks' slabs."""
        return torch.maximum((g_c * free_cam[:, None]).abs().max(),
                             pmax((g_p * pv[:, None]).abs().max()))

    def apply_step(R, t, X, dc, dp):
        return (angle_axis_to_matrix(dc[:, :3]) @ R, t + dc[:, 3:], X + dp)

    chunk = min(schur_chunk, P)
    cam_rows = prob.obs_cam                                  # (P, T)

    def dense_solve(U_d, Vinv, W, g_c, g_p, focal, lam):
        """Build S and its rhs densely (chunked one-hot matmul) and solve."""
        Y = _mm(W, Vinv[pt_o])                               # (O, 6, 3)
        Ygp = to_cams(_mv(Y, g_p[pt_o]))                     # (C, 6)

        def rows_of(B):    # back to the (P, T) layout, zero blocks at padding
            return torch.zeros((P * T, 6, 3), dtype=f32, device=dev).index_copy_(
                0, obs, B).view(P, T, 6, 3)

        Yr, Wr = rows_of(Y), rows_of(W)
        S = torch.zeros((C * 6, C * 6), dtype=f32, device=dev)
        for s in range(0, P, chunk):
            oh = torch.nn.functional.one_hot(cam_rows[s:s + chunk], C).to(f32)
            n = oh.shape[0]
            Yg = torch.einsum("ptc,ptij->cipj", oh, Yr[s:s + chunk])
            Wg = torch.einsum("ptc,ptij->cipj", oh, Wr[s:s + chunk])
            S -= Yg.reshape(C * 6, n * 3) @ Wg.reshape(C * 6, n * 3).T
        if focal is not None:
            Jf, U_ff, U_cf, g_f, Wf_sum = focal
            # Schur-reduce the shared-focal columns against the point blocks.
            VinvWfT = _mm(Vinv, Wf_sum.transpose(-1, -2))    # (Pn, 3, 2)
            Ygp, S, Wff, Wcf, Wgf = psum(
                Ygp, S, torch.einsum("pij,pjk->ik", Wf_sum, VinvWfT),
                to_cams(_mm(Y, Wf_sum[pt_o].transpose(-1, -2))),   # (C, 6, 2)
                _mv(_mm(Wf_sum, Vinv), g_p).sum(0))
        else:
            Ygp, S = psum(Ygp, S)
        rhs = g_c - Ygp
        S4 = S.view(C, 6, C, 6)
        ci = torch.arange(C, device=dev)
        S4[ci, :, ci, :] = S4[ci, :, ci, :] + U_d
        if focal is not None:
            S_ff = U_ff - Wff
            dff = torch.clamp(torch.diagonal(S_ff), min_lm_diagonal, max_lm_diagonal)
            S_ff = S_ff + torch.diag(lam * dff)
            S_cf = (U_cf - Wcf).reshape(C * 6, 2)
            rhs_f = g_f - Wgf
            S = torch.cat([torch.cat([S, S_cf], 1),
                           torch.cat([S_cf.T, S_ff], 1)], 0)
            rhs = torch.cat([rhs.reshape(-1), rhs_f])
        else:
            rhs = rhs.reshape(-1)
        # Jacobi equilibration keeps the f32 Cholesky healthy.
        dinv = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(S), min=1e-12))
        L, info = torch.linalg.cholesky_ex(S * dinv[:, None] * dinv[None, :])
        sol = torch.cholesky_solve((rhs * dinv)[:, None], L)[:, 0] * dinv
        sol = torch.where(info == 0, sol, torch.nan)
        if focal is not None:
            return sol[:C * 6].reshape(C, 6), sol[C * 6:]
        return sol.reshape(C, 6), None

    def try_step_dense(K, R, t, X, lam):
        r, Jc, Jp, p, inv_z = linearize(K, R, t, X)
        cost = 0.5 * (r * r).sum()
        U = to_cams(_tmm(Jc, Jc))
        g_c = to_cams(-_mv(Jc.transpose(-1, -2), r))
        V = to_points(_tmm(Jp, Jp))
        g_p = to_points(-_mv(Jp.transpose(-1, -2), r))
        W = _tmm(Jc, Jp)                                       # (O, 6, 3)
        focal = None
        if refine_focal:
            # Shared-focal columns (CeresBundleOptimizer.cpp:76-121):
            # d ru / d fx = x/z, d rv / d fy = y/z; off-diagonals zero.
            xn = p[:, 0] * inv_z
            yn = p[:, 1] * inv_z
            zf = torch.zeros_like(xn)
            Jf = torch.stack([torch.stack([xn, zf], -1),
                              torch.stack([zf, yn], -1)], -2)  # (O, 2, 2)
            U_ff = torch.einsum("oki,okj->ij", Jf, Jf)
            U_cf = to_cams(_tmm(Jc, Jf))
            g_f = -torch.einsum("oki,ok->i", Jf, r)
            Wf_sum = to_points(_tmm(Jf, Jp))                   # (Pn, 2, 3)
            cost, U, g_c, U_ff, U_cf, g_f = psum(cost, U, g_c, U_ff, U_cf, g_f)
            focal = (Jf, U_ff, U_cf, g_f, Wf_sum)
        else:
            cost, U, g_c = psum(cost, U, g_c)
        g_inf = gradient_inf(g_c, g_p)
        U_d, V_d = damp(U, V, lam)
        Vinv = _inv3x3(V_d)
        dc, df = dense_solve(U_d, Vinv, W, g_c, g_p, focal, lam)
        dc = dc * free_cam[:, None]
        rhs_p = g_p - to_points(_mv(W.transpose(-1, -2), dc[cam_o]))
        if focal is not None:
            rhs_p = rhs_p - torch.einsum("pij,i->pj", focal[4], df)
        dp = _mv(Vinv, rhs_p) * pv[:, None]
        # Predicted cost reduction -g.dx - 0.5 dx^T H dx, through J dx.
        Jdx = _mv(Jc, dc[cam_o]) + _mv(Jp, dp[pt_o])
        if focal is not None:
            Jdx = Jdx + _mv(focal[0], df)
        R_new, t_new, X_new = apply_step(R, t, X, dc, dp)
        K_new = K
        if focal is not None:
            K_new = K + torch.cat([df, torch.zeros_like(df)])
        pred, new_cost, dp_sq = psum(
            -(r * Jdx).sum() - 0.5 * (Jdx * Jdx).sum(),
            cost_of(K_new, R_new, t_new, X_new), (dp * dp).sum())
        step_sq = (dc * dc).sum() + dp_sq     # dc is replicated, dp sharded
        if focal is not None:
            step_sq = step_sq + (df * df).sum()
        return cost, new_cost, pred, K_new, R_new, t_new, X_new, step_sq, g_inf, 0

    def try_step_pcg(K, R, t, X, lam):
        r, Jc, Jp, _, _ = linearize(K, R, t, X)
        cost = 0.5 * (r * r).sum()
        U = to_cams(_tmm(Jc, Jc))
        g_c = to_cams(-_mv(Jc.transpose(-1, -2), r))
        V = to_points(_tmm(Jp, Jp))
        g_p = to_points(-_mv(Jp.transpose(-1, -2), r))
        W = _tmm(Jc, Jp)                                       # cached (O, 6, 3)
        del Jc, Jp
        cost, U, g_c = psum(cost, U, g_c)
        g_inf = gradient_inf(g_c, g_p)
        U_d, V_d = damp(U, V, lam)
        Vi = _inv3x3(V_d)
        Uinv = torch.linalg.inv_ex(U_d)[0]

        def WT_pts(x):     # (C, 6) -> (Pn, 3): per-point sum of W^T x_cam
            return to_points(_mv(W.transpose(-1, -2), x[cam_o]))

        def Wy_cams(y):    # (Pn, 3) -> (C, 6): per-camera sum of W y_p
            return to_cams(_mv(W, y[pt_o]))

        def S_mul(x):
            # U_d x is replicated: only the point-sharded term is reduced.
            return _mv(U_d, x) - psum(Wy_cams(_mv(Vi, WT_pts(x))))[0]

        rhs = g_c - psum(Wy_cams(_mv(Vi, g_p)))[0]
        x = torch.zeros_like(rhs)
        res = rhs
        z = _mv(Uinv, res)
        pvec = z
        rz = (res * z).sum()
        tol2 = (pcg_rtol * pcg_rtol) * (rhs * rhs).sum()
        k = 0
        while k < pcg_iters and bool((res * res).sum() > tol2):
            Sp = S_mul(pvec)
            alpha = rz / torch.clamp((pvec * Sp).sum(), min=1e-20)
            x = x + alpha * pvec
            res = res - alpha * Sp
            z = _mv(Uinv, res)
            rz_new = (res * z).sum()
            pvec = z + (rz_new / torch.clamp(rz, min=1e-20)) * pvec
            rz = rz_new
            k += 1
        dc = x * free_cam[:, None]
        dp = _mv(Vi, g_p - WT_pts(dc)) * pv[:, None]
        # Predicted reduction from the cached blocks (g = -J^T r):
        # pred = g.dx - 0.5 dx^T (J^T J) dx, all undamped.
        R_new, t_new, X_new = apply_step(R, t, X, dc, dp)
        s_gp, s_w, s_v, new_cost, dp_sq = psum(
            (g_p * dp).sum(), (dc * Wy_cams(dp)).sum(),
            (dp * _mv(V, dp)).sum(), cost_of(K, R_new, t_new, X_new),
            (dp * dp).sum())
        s_g = (g_c * dc).sum() + s_gp
        s_u = (dc * _mv(U, dc)).sum()
        pred = s_g - 0.5 * (s_u + 2.0 * s_w + s_v)
        step_sq = (dc * dc).sum() + dp_sq
        return cost, new_cost, pred, K, R_new, t_new, X_new, step_sq, g_inf, k

    try_step = try_step_dense if solve_mode == "dense" else try_step_pcg
    num_res, cost0 = psum(num_res, cost_of(prob.K, prob.R, prob.t, prob.X))
    if init_state is None:
        K, R, t, X = prob.K, prob.R, prob.t, prob.X
        radius, cost, it, done = initial_radius, cost0, 0, False
    else:
        K, R, t, X = (torch.as_tensor(v, dtype=f32, device=dev)
                      for v in init_state[:4])
        radius, cost, it, done = init_state[4:]
    radius = torch.as_tensor(radius, dtype=f32, device=dev)
    cost = torch.as_tensor(cost, dtype=f32, device=dev)
    it, done, cg_steps = int(it), bool(done), 0
    while it < max_iterations and not done:
        (cost_cur, new_cost, pred, K_new, R_new, t_new, X_new, step_sq,
         g_inf, k) = try_step(K, R, t, X, 1.0 / radius)
        cg_steps += k
        rho = (cost_cur - new_cost) / torch.clamp(pred, min=1e-20)
        accept = (rho > 0) & (new_cost < cost_cur) & torch.isfinite(new_cost)
        # Ceres-style radius update.
        shrink = 1.0 - (2.0 * rho - 1.0) ** 3
        radius_new = torch.where(accept, radius / torch.clamp(shrink, min=1.0 / 3.0),
                                 radius / 2.0)
        radius = torch.clamp(radius_new, 1e-16, 1e16)
        K = torch.where(accept, K_new, K)
        R = torch.where(accept, R_new, R)
        t = torch.where(accept, t_new, t)
        X = torch.where(accept, X_new, X)
        cost = torch.where(accept, new_cost, cost_cur)
        f_conv = accept & ((cost_cur - new_cost).abs() <= function_tolerance * cost_cur)
        x_conv = accept & (torch.sqrt(step_sq) <= parameter_tolerance)
        g_conv = g_inf <= gradient_tolerance
        stuck = ~accept & (radius <= 1e-14)
        done = bool(f_conv | x_conv | g_conv | stuck)
        it += 1
    denom = torch.clamp(num_res, min=1.0)
    reproj = psum(torch.linalg.norm(project(K, R, t, X)[0], dim=-1).sum())[0]
    return {
        "R": R,
        "t": t,
        "X": X,
        "K": K,
        "cost_initial": cost0,
        "cost_final": cost,
        "iterations": it,
        # Per-residual-component RMSE (Ceres convention: 2 components/obs).
        "rmse_initial": torch.sqrt(cost0 / denom),
        "rmse_final": torch.sqrt(cost / denom),
        # Mean Euclidean reprojection error per observation.
        "mean_reproj_error": reproj / denom,
        "num_residuals": num_res,
        "radius": radius,
        "converged": done,
        "cg_steps": cg_steps,
    }


def bundle_adjust_refine_focal(prob: BundleProblem, max_iterations: int = 50,
                               **kwargs) -> dict[str, Any]:
    """Shared-focal bundle adjustment (reference refine_focal_length option,
    CeresBundleOptimizer.cpp:76-121): the two global (fx, fy) columns ride
    inside the dense Schur-reduced camera system."""
    return bundle_adjust(prob, max_iterations=max_iterations,
                         refine_focal=True, **kwargs)
