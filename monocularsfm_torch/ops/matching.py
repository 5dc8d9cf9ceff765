"""Descriptor matching: similarity statistics + ratio + cross-check.

The port of monocularsfm_tpu/ops/matching.py (reference parity:
src/Feature/FeatureUtils.cpp ComputeMatches :141-157, ComputeCrossMatches
:160-174, FilterMatchesByDistance :208-218).  Descriptors are unit-L2
(RootSIFT), so dist = sqrt(2 - 2 * sim) and the k=2 nearest-neighbour search
is a similarity product.  The statistics come from ops/match_kernel.py
(kernel 3 on the card); the decision below is plain torch.

Output format is an index map `idx_b: int32[N_A]` (-1 where no match
survived); hosts convert to (i, j) lists with `matches_to_pairs`.
"""

from __future__ import annotations

import numpy as np
import torch

from monocularsfm_torch.ops.match_kernel import (
    NEG,
    match_stats,
    match_stats_pair,
    match_stats_plain,
    match_stats_plain_batch,
)

# match_pairs_batch's `kernel` values: the reference's strings, and the
# port's own booleans.  "xla" and False take the plain statistics.
KERNEL_CHOICES = ("auto", "pallas", "xla", True, False)


def _dist(sim):
    return torch.sqrt(torch.clamp(2.0 - 2.0 * sim, min=0.0))


def _decide(mask_a, stats, ratio, max_distance, cross_check):
    """Ratio, distance and mutual cross-check decision on the six
    statistics (leading batch dims allowed).  Returns int32 idx_b."""
    t1, i1, t2, col1, colarg, col2 = stats
    n_a, n_b = t1.shape[-1], col1.shape[-1]
    d1 = _dist(t1)
    ok = mask_a & (t1 > NEG / 2)
    # Lowe ratio, forward direction (FeatureUtils.cpp:148-153).
    ok &= d1 < ratio * _dist(t2)
    # Absolute distance filter (FeatureUtils.cpp:208-218).
    ok &= d1 <= max_distance
    if cross_check:
        j = torch.clamp(i1, 0, n_b - 1).long()
        rows = torch.arange(n_a, dtype=torch.int32, device=t1.device)
        # Mutual best (CrossCheck, FeatureUtils.cpp:281-310) and the
        # reverse-direction ratio test.
        ok &= torch.gather(colarg, -1, j) == rows
        ok &= (_dist(torch.gather(col1, -1, j))
               < ratio * _dist(torch.gather(col2, -1, j)))
    return torch.where(ok, i1, -1).to(torch.int32)


def match_descriptors_pair(desc_a, desc_b, mask_a, mask_b, ratio: float = 0.8,
                           max_distance: float = 0.7, cross_check: bool = True,
                           col_tile: int = 1024) -> torch.Tensor:
    """Match descriptors A->B with the plain statistics (the reference's
    column-tiled scan).  Returns idx_b: int32[N_A], -1 where unmatched."""
    stats = match_stats_plain(desc_a, desc_b, mask_a, mask_b, col_tile)
    return _decide(mask_a, stats, ratio, max_distance, cross_check)


def match_descriptors_pair_auto(desc_a, desc_b, mask_a, mask_b,
                                ratio: float = 0.8, max_distance: float = 0.7,
                                cross_check: bool = True,
                                col_tile: int = 1024) -> torch.Tensor:
    """The single-pair matcher by device: on CUDA tensors one launch of
    kernel 3 (desc_a (N_A, 128), desc_b (N_B, 128), each capacity a
    multiple of 128, any two), on CPU tensors the plain statistics of
    `match_descriptors_pair`.  The same idx_b: int32[N_A] either way."""
    stats = match_stats_pair(desc_a, desc_b, mask_a, mask_b, col_tile)
    return _decide(mask_a, stats, ratio, max_distance, cross_check)


def match_pairs_batch(desc_bank, mask_bank, pair_ids, ratio: float = 0.8,
                      max_distance: float = 0.7, cross_check: bool = True,
                      col_tile: int = 1024,
                      kernel: "str | bool" = "auto") -> torch.Tensor:
    """Returns idx_b: int32 (P, N) match map per pair.

    desc_bank (I, N, D) (bfloat16 on CUDA), mask_bank (I, N) bool, pair_ids
    (P, 2) int32 rows of the bank.  `kernel`, as the reference reads it:
    "auto" (the default) and "pallas" take `match_stats`, which is kernel 3
    on CUDA tensors and the plain statistics on CPU tensors (where the
    reference interprets its kernel); "xla" forces the plain statistics on
    any device, for comparing the two.  True and False mean "auto" and
    "xla"."""
    if kernel not in KERNEL_CHOICES:
        raise ValueError(f"kernel must be one of {KERNEL_CHOICES}, got {kernel!r}")
    pair_ids = torch.as_tensor(pair_ids, dtype=torch.int32,
                               device=desc_bank.device)
    if kernel in ("auto", "pallas", True):
        stats = match_stats(desc_bank, mask_bank, pair_ids, col_tile)
    else:
        stats = match_stats_plain_batch(desc_bank, mask_bank, pair_ids,
                                        col_tile)
    mask_a = mask_bank[pair_ids[:, 0].long()]
    return _decide(mask_a, stats, ratio, max_distance, cross_check)


def matches_to_pairs(idx_b) -> "tuple":
    """Host-side: index map -> (i, j) int32 arrays of matched keypoint ids."""
    if isinstance(idx_b, torch.Tensor):
        idx_b = idx_b.cpu().numpy()
    idx_b = np.asarray(idx_b)
    i = np.nonzero(idx_b >= 0)[0].astype(np.int32)
    return i, idx_b[i].astype(np.int32)
