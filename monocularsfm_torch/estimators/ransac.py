"""Hypothesis-parallel RANSAC machinery.

The port of monocularsfm_tpu/estimators/ransac.py: every hypothesis lives in
one batch (sample M minimal sets, solve M models, score M x N residuals,
take the best).  Minimal sets come from the top-k of one uniform key per
(hypothesis, candidate), invalid candidates pushed to -inf: uniform sampling
without replacement, fixed shapes.

The uniform keys are an argument, not drawn here: torch cannot reproduce
jax.random, so the matcher draws them from its own torch.Generator and the
parity tests hand in the reference's draws.
"""

from __future__ import annotations

import math

import torch


def sample_minimal_sets(u: torch.Tensor, k: int,
                        valid: torch.Tensor) -> torch.Tensor:
    """Index sets of size k from the valid candidates.

    u: (..., M, N) uniform keys, valid: bool (..., N).  Returns int64
    (..., M, k).  If fewer than k candidates are valid the sets repeat
    indices; callers gate on num_valid >= k."""
    keys = torch.where(valid[..., None, :], u, -math.inf)
    return torch.topk(keys, k, dim=-1).indices


def score_hypotheses(residuals: torch.Tensor, valid: torch.Tensor,
                     threshold: float):
    """MSAC-style scoring. residuals: (..., M, N) >= 0, valid: (..., N).

    Returns (best_index (...,), inlier_mask_of_best (..., N), inlier_counts
    (..., M)).  The winner maximises inlier count with the truncated-residual
    sum as a tie-break; the first hypothesis wins exact ties."""
    v = valid[..., None, :]
    inl = (residuals <= threshold) & v
    counts = inl.sum(-1)
    trunc = torch.where(inl, residuals, threshold)
    msac = torch.where(v, trunc, 0.0).sum(-1)
    nvalid = torch.clamp(valid.sum(-1), min=1).float()[..., None]
    score = counts.float() - msac / (threshold * nvalid)
    best = torch.argmax(score, dim=-1)
    best_inl = torch.gather(
        inl, -2, best[..., None, None].expand(*best.shape, 1, inl.shape[-1]))
    return best, best_inl[..., 0, :], counts


def num_ransac_iterations(confidence: float, inlier_ratio: float, sample_size: int,
                          max_iterations: int = 10000) -> int:
    """Classic adaptive-iteration formula (host-side)."""
    eps = 1e-9
    w = max(min(inlier_ratio, 1 - eps), eps)
    denom = math.log(max(1 - w ** sample_size, eps))
    if denom >= 0:
        return max_iterations
    return int(min(max_iterations, math.ceil(math.log(1 - confidence) / denom)))


def rounds_to_confidence(
    confidence: float,
    inlier_count: int,
    num_valid: int,
    sample_size: int,
    hyps_per_round: int,
    max_rounds: int | None = None,
) -> int:
    """Total hypothesis ROUNDS the classic termination bound demands.

    One fixed `hyps_per_round`-wide batch runs first; if the best model so
    far leaves 1-(1-w^m)^k below `confidence`, the caller runs further
    rounds of the same shape and keeps the best.  The default cap lets the
    total budget reach the reference's 10000-iteration ceiling
    (Initializer.cpp:103-159, Registrant.h:22-27)."""
    if max_rounds is None:
        max_rounds = max(1, math.ceil(10000 / max(hyps_per_round, 1)))
    need = num_ransac_iterations(
        confidence,
        inlier_count / max(num_valid, 1),
        sample_size,
    )
    return min(max_rounds, max(1, math.ceil(need / hyps_per_round)))
