"""The port's matcher (kernel 3's plain version on the CPU) against the JAX
package's Pallas matcher in interpret mode and its scan matcher."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocularsfm_torch.ops import match_kernel
from monocularsfm_torch.ops.matching import (
    match_descriptors_pair,
    match_pairs_batch,
    matches_to_pairs,
)
from monocularsfm_tpu.ops.matching import match_descriptors_pair as jax_scan
from monocularsfm_tpu.ops.pallas_matching import match_descriptors_pair_pallas
from test_matching import _planted_pair

AGREE = 0.999
MARGIN = 1e-5  # a disagreement must sit on a tie within f32 summation noise
RATIO, MAXD = 0.8, 0.7


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _margin(da, db, ma, mb, i, cross_check):
    """Smallest decision margin of row i: top-1/top-2 gap, ratio test and
    distance test, in both directions when cross-checking."""
    t1, i1, t2, col1, _, col2 = match_kernel.match_stats_plain(*_t(da, db, ma, mb))
    dist = lambda s: np.sqrt(max(2.0 - 2.0 * float(s), 0.0))  # noqa: E731
    m = [abs(t1[i] - t2[i]).item(),
         abs(dist(t1[i]) - RATIO * dist(t2[i])),
         abs(dist(t1[i]) - MAXD)]
    if cross_check:
        j = int(i1[i])
        m += [abs(col1[j] - col2[j]).item(),
              abs(dist(col1[j]) - RATIO * dist(col2[j]))]
    return min(m)


@pytest.mark.parametrize("cross_check", [True, False])
def test_plain_matcher_matches_pallas_and_scan(cross_check):
    rng = np.random.default_rng(5)
    da, db, ma, mb, _ = _planted_pair(rng, n=700, cap=1024, noise=0.06)
    jargs = [jnp.asarray(x) for x in (da, db, ma, mb)]
    pallas = np.asarray(match_descriptors_pair_pallas(
        *jargs, ratio=RATIO, max_distance=MAXD, cross_check=cross_check,
        row_tile=256, col_tile=256, interpret=True))
    scan = np.asarray(jax_scan(*jargs, ratio=RATIO, max_distance=MAXD,
                               cross_check=cross_check, col_tile=256))
    ours = match_descriptors_pair(*_t(da, db, ma, mb), ratio=RATIO,
                                  max_distance=MAXD, cross_check=cross_check,
                                  col_tile=256).numpy()
    assert (ours >= 0).sum() > 500
    for ref in (pallas, scan):
        assert (ours == ref).mean() >= AGREE
        for i in np.nonzero(ours != ref)[0]:
            assert _margin(da, db, ma, mb, i, cross_check) < MARGIN, i


def test_all_masked_matches_nothing():
    cap = 512
    z = np.zeros((cap, 128), np.float32)
    off = np.zeros(cap, bool)
    ours = match_descriptors_pair(*_t(z, z, off, off), col_tile=128)
    assert (ours.numpy() == -1).all()
    ref = np.asarray(match_descriptors_pair_pallas(
        *(jnp.asarray(x) for x in (z, z, off, off)), row_tile=256,
        col_tile=256, interpret=True))
    assert (ref == -1).all()


def test_batch_equals_per_pair_results():
    rng = np.random.default_rng(6)
    bank, mask = [], []
    base = rng.standard_normal((300, 128)).astype(np.float32)
    for i in range(4):
        d = np.zeros((1024, 128), np.float32)
        n = 200 + 30 * i
        x = base[:n] + 0.25 * rng.standard_normal((n, 128)).astype(np.float32)
        d[:n] = x / np.linalg.norm(x, axis=1, keepdims=True)
        bank.append(d)
        mask.append(np.arange(1024) < n)
    bank, mask = torch.from_numpy(np.stack(bank)), torch.from_numpy(np.stack(mask))
    pairs = [[0, 1], [2, 3], [1, 3], [3, 0]]
    match_kernel.reset_launches()
    out = match_pairs_batch(bank, mask, pairs, col_tile=256)
    plain = match_pairs_batch(bank, mask, pairs, col_tile=1024, kernel=False)
    assert match_kernel.LAUNCHES["match_tile"] == 0  # CPU: plain version
    assert torch.equal(out, plain)
    for k, (a, b) in enumerate(pairs):
        single = match_descriptors_pair(bank[a], bank[b], mask[a], mask[b])
        assert torch.equal(out[k], single)
        assert (single >= 0).sum() > 50
    i, j = matches_to_pairs(out[0])
    assert (out[0].numpy()[i] == j).all()


def test_merged_tile_partials_equal_plain_statistics():
    """The kernel's epilogue: per-128-tile partials with first-index argmax,
    merged by `_merge_partials`, give the whole-matrix statistics, ties
    included."""
    rng = np.random.default_rng(7)
    n, T = 512, match_kernel.TILE
    da, db, ma, mb, _ = _planted_pair(rng, n=400, cap=n, noise=0.1)
    db[300:310] = db[200]          # exact duplicate columns: argmax ties
    a, b, ma_t, mb_t = _t(da, db, ma, mb)
    sims = a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float().T
    sims = torch.where(ma_t[:, None] & mb_t[None, :], sims, match_kernel.NEG)
    G = n // T
    rows = [match_kernel._top2(sims[:, c * T:(c + 1) * T], 1) for c in range(G)]
    cols = [match_kernel._top2(sims[r * T:(r + 1) * T], 0) for r in range(G)]
    rt1, ri1, rt2 = (torch.stack(x)[None] for x in zip(*rows))
    ct1, ci1, ct2 = (torch.stack(x)[None] for x in zip(*cols))
    ri1 = ri1 + (torch.arange(G, dtype=torch.int32) * T)[None, :, None]
    ci1 = ci1 + (torch.arange(G, dtype=torch.int32) * T)[None, :, None]
    merged = (match_kernel._merge_partials(rt1, ri1, rt2)
              + match_kernel._merge_partials(ct1, ci1, ct2))
    plain = match_kernel.match_stats_plain(a, b, ma_t, mb_t, col_tile=128)
    for m, p in zip(merged, plain):
        assert torch.equal(m[0], p)
