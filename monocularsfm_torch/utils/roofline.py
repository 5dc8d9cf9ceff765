"""Least device time of the kernels' work on one NVIDIA H100 SXM.

A kernel's bound is the larger of two times: the bytes its function must
move (each input read once, each output written once) over the card's
memory rate, and the operations it does over the peak rate of their type.
Peaks are NVIDIA's published dense rates for the H100 SXM at its 700 W
limit; a card set to a lower power limit may not reach them.  Work that
depends on the data is counted for the data given (the matcher's valid
rows and columns), not for the most it could be.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"fp32": 67e12, "bf16": 989e12}


def bound(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    """(bound in ms, "bytes" or "operations", whichever sets it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[kind]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def blur_v_work(B: int, H: int, W: int, C: int, T: int) -> tuple[float, float]:
    """Bytes and fp32 flops of the vertical pass (B, H, W) -> (B, C, H, W)."""
    px = B * H * W
    return 4.0 * px * (1 + C) + 4.0 * C * T, 2.0 * px * C * T


def blur_h_work(B: int, H: int, W: int, C: int, T: int) -> tuple[float, float]:
    """Bytes and fp32 flops of the horizontal pass over (B, C, H, W)."""
    px = B * C * H * W
    return 8.0 * px + 4.0 * C * T, 2.0 * px * T


def blur_multi_work(B: int, H: int, W: int, C: int, T: int) -> tuple[float, float]:
    """Bytes and fp32 flops of the fused pass (B, H, W) -> (B, C, H, W): both
    axes' taps, the base read once and the result written once."""
    px = B * H * W
    return 4.0 * px * (1 + C) + 4.0 * C * T, 2.0 * px * C * 2 * T


def match_work(valid, pairs, N: int, D: int = 128,
               N_b: int | None = None) -> tuple[float, float]:
    """Bytes and bf16 flops of the six statistics of a batch of pairs.

    valid[i]: the number of valid descriptors of image i (its mask's
    count); pairs: (ia, ib) images of side A (capacity N) and side B
    (capacity N_b, N where not given: one bank for both sides).  Reads each
    used image's valid descriptors once (bf16) and its mask; writes three
    (P, N) row words and three (P, N_b) column words."""
    N_b = N if N_b is None else N_b
    cap = {a: N for a, _ in pairs} | {b: N_b for _, b in pairs}
    nbytes = (sum(2.0 * D * valid[i] + c for i, c in cap.items())
              + 3 * 4.0 * len(pairs) * (N + N_b))
    ops = sum(2.0 * D * valid[a] * valid[b] for a, b in pairs)
    return nbytes, ops


def schur_work(n_obs: int, n_points: int, n_cams: int,
               gathered: bool = False) -> tuple[float, float]:
    """Bytes and fp32 flops of one product with the Schur complement in its
    two-pass form (csrc/schur.cu): each observation's W block (72 bytes)
    and its point, camera and camera-order row (int32), the 6-float
    payload written and read back (the kernel pads its rows to 8 floats,
    which is not counted), the order's int32 where the
    observations are gathered into point order; each point's Vi (36
    bytes) with observations; each camera's x, U_d, first row and result.
    Flops: W^T x and W y (36 each), the point and camera sums (9) an
    observation, Vi z (18) a point, U_d x and the difference (78) a
    camera."""
    per_obs = 72 + 12 + 48 + (4 if gathered else 0)
    nbytes = (per_obs * n_obs + 36.0 * n_points
              + n_cams * (24 + 144 + 4 + 24) + 4)
    return float(nbytes), 81.0 * n_obs + 18.0 * n_points + 78.0 * n_cams
