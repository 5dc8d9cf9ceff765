"""Plain bundle geometry in float64: the reference's arithmetic.

Pinhole projection, the similarity that best maps one set of camera
centres onto another (Umeyama), and the cost and block Gauss-Newton
decrease of a bundle: how much one exact step of the points alone, or of
the cameras alone, would still lower the cost.  At a bundle's optimum both are nought but for rounding; a
solve that stopped early, or a state that was left unchanged, leaves them
large.  Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64


def centres(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Camera centres -R^T t of world-to-camera poses (..., 3, 3), (..., 3)."""
    return -np.einsum("...ji,...j->...i", R, t)


def umeyama(src: np.ndarray, dst: np.ndarray):
    """Similarity (s, R, t) minimising |s R src + t - dst|^2."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    U, D, Vt = np.linalg.svd(xd.T @ xs / len(src))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / max((xs ** 2).sum() / len(src), 1e-300))
    return s, R, mu_d - s * R @ mu_s


def _skew(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def bundle_terms(K, R, t, X, cam, pt, uv):
    """Residuals and Jacobians of every observation in float64.

    K (4,) fx, fy, cx, cy; R (C, 3, 3), t (C, 3), X (P, 3); observation o
    sees point pt[o] from camera cam[o] at pixel uv[o].  Returns r (O, 2),
    J_X (O, 2, 3) and J_c (O, 2, 6) for a left rotation increment and a
    translation increment."""
    K = torch.as_tensor(K, dtype=F64)
    RX = torch.einsum("oij,oj->oi", R[cam], X[pt])
    xc = RX + t[cam]
    z = xc[:, 2]
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    u = fx * xc[:, 0] / z + cx
    v = fy * xc[:, 1] / z + cy
    r = torch.stack([u, v], -1) - uv
    Jp = torch.zeros((len(z), 2, 3), dtype=F64, device=X.device)
    Jp[:, 0, 0] = fx / z
    Jp[:, 0, 2] = -fx * xc[:, 0] / (z * z)
    Jp[:, 1, 1] = fy / z
    Jp[:, 1, 2] = -fy * xc[:, 1] / (z * z)
    J_X = Jp @ R[cam]
    J_c = torch.cat([-Jp @ _skew(RX), Jp], -1)
    return r, J_X, J_c


def _block_decrease(J, r, idx, n, dim, skip=None):
    """sum over blocks of 0.5 g^T H^-1 g, blocks by `idx` (n of them)."""
    H = torch.zeros((n, dim, dim), dtype=F64, device=J.device)
    g = torch.zeros((n, dim), dtype=F64, device=J.device)
    H.index_add_(0, idx, J.transpose(1, 2) @ J)
    g.index_add_(0, idx, torch.einsum("oki,ok->oi", J, r))
    keep = torch.zeros(n, dtype=torch.bool, device=J.device)
    keep[idx] = True
    if skip is not None:
        keep &= ~skip
    H, g = H[keep], g[keep]
    if dim == 3:
        # Adjugate inverse, elementwise: no batched solver's size limits.
        # Blocks seen too weakly to invert (one view) change nothing.
        adj = torch.stack([torch.linalg.cross(H[:, 1], H[:, 2]),
                           torch.linalg.cross(H[:, 2], H[:, 0]),
                           torch.linalg.cross(H[:, 0], H[:, 1])], -1)
        det = (H[:, 0] * adj[:, :, 0]).sum(-1)
        scale = (H.diagonal(dim1=1, dim2=2).sum(-1) / 3) ** 3
        ok = det > 1e-10 * scale
        sol = torch.einsum("oij,oj->oi", adj[ok], g[ok]) / det[ok, None]
        return 0.5 * float((g[ok] * sol).sum())
    total = 0.0
    for s in range(0, len(H), 16384):
        Hs, gs = H[s:s + 16384], g[s:s + 16384]
        sol = torch.linalg.solve(Hs, gs)
        total += 0.5 * float((gs * sol).sum())
    return total


def bundle_gain(K, R, t, X, cam, pt, uv, cam_const=None) -> dict:
    """Cost 0.5 |r|^2 of a bundle and the relative decreases one exact
    Gauss-Newton step of the points alone (`point_gain`) and of the free
    cameras alone (`camera_gain`) would give, in float64, on the device
    the tensors lie on."""
    dev = X.device
    R, t, X, uv = (torch.as_tensor(a, dtype=F64, device=dev)
                   for a in (R, t, X, uv))
    cam = torch.as_tensor(cam, dtype=torch.long, device=dev)
    pt = torch.as_tensor(pt, dtype=torch.long, device=dev)
    r, J_X, J_c = bundle_terms(K, R, t, X, cam, pt, uv)
    cost = 0.5 * float((r * r).sum())
    dp = _block_decrease(J_X, r, pt, len(X), 3)
    skip = None if cam_const is None else torch.as_tensor(
        cam_const, dtype=torch.bool, device=dev)
    dc = _block_decrease(J_c, r, cam, len(R), 6, skip)
    return {"cost": cost, "point_gain": dp / cost, "camera_gain": dc / cost,
            "mean_reproj_px": float(torch.linalg.norm(r, dim=1).mean())}
