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


def match_work(valid, pairs, N: int, D: int = 128) -> tuple[float, float]:
    """Bytes and bf16 flops of the six statistics of a batch of pairs.

    valid[i]: the number of valid descriptors of image i (its mask's
    count); pairs: (ia, ib) rows of the bank.  Reads each used image's
    valid descriptors once (bf16) and its mask; writes six (P, N) words."""
    used = {i for p in pairs for i in p}
    nbytes = sum(2.0 * D * valid[i] + N for i in used) + 6 * 4.0 * len(pairs) * N
    ops = sum(2.0 * D * valid[a] * valid[b] for a, b in pairs)
    return nbytes, ops
