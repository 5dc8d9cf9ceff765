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
    """The kernel's output: final row statistics, and per-128-row-block
    column partials with first-index argmax merged by `_merge_partials`,
    give the whole-matrix statistics, ties included."""
    rng = np.random.default_rng(7)
    n = 512
    da, db, ma, mb, _ = _planted_pair(rng, n=400, cap=n, noise=0.1)
    db[300:310] = db[200]          # exact duplicate columns: argmax ties
    da[350:360] = da[100]          # exact duplicate rows: column ties
    bank = torch.from_numpy(np.stack([da, db]))
    mask = torch.from_numpy(np.stack([ma, mb]))
    pairs = torch.tensor([[0, 1], [1, 0]], dtype=torch.int32)
    cols = match_kernel.column_partials_plain(bank, mask, pairs)
    merged = match_kernel._merge_partials(*cols)
    plain = match_kernel.match_stats_plain_batch(bank, mask, pairs, col_tile=128)
    for m, p in zip(merged, plain[3:]):
        assert torch.equal(m, p)


@pytest.mark.parametrize("cap", [128, 384])
def test_column_partials_layout(cap):
    """(P, N / 128, N) column partials: block g holds the top-2 of rows
    128 g .. 128 g + 127 with global row indices; masked rows and columns
    read NEG, a fully masked column gives the block's first row."""
    rng = np.random.default_rng(cap)
    bank = torch.from_numpy(rng.standard_normal((3, cap, 128)).astype(np.float32))
    mask = torch.from_numpy(rng.random((3, cap)) < 0.8)
    mask[2] = False
    pairs = torch.tensor([[0, 1], [2, 0], [1, 2]], dtype=torch.int32)
    t1, i1, t2 = match_kernel.column_partials_plain(bank, mask, pairs)
    G = cap // match_kernel.TILE
    assert t1.shape == i1.shape == t2.shape == (3, G, cap)
    assert i1.dtype == torch.int32
    for k, (ia, ib) in enumerate(pairs.tolist()):
        a = bank[ia].to(torch.bfloat16).float()
        b = bank[ib].to(torch.bfloat16).float()
        sims = torch.where(mask[ia][:, None] & mask[ib][None, :], a @ b.T,
                           match_kernel.NEG)
        for g in range(G):
            blk = sims[128 * g:128 * (g + 1)]
            assert torch.equal(t1[k, g], blk.amax(0))
            assert torch.equal(i1[k, g], blk.argmax(0).int() + 128 * g)
            srt = blk.sort(0, descending=True).values
            assert torch.equal(t2[k, g], srt[1])
    assert (t1[1] == match_kernel.NEG).all() and (i1[1] == 128 * torch.arange(G)[:, None]).all()
    merged = match_kernel._merge_partials(t1, i1, t2)
    plain = match_kernel.match_stats_plain_batch(bank, mask, pairs, col_tile=128)
    for m, p in zip(merged, plain[3:]):
        assert torch.equal(m, p)
