"""The port's matcher (kernel 3's plain version on the CPU) against the JAX
package's Pallas matcher in interpret mode and its scan matcher."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocularsfm_torch.ops import match_kernel
from monocularsfm_torch.ops.matching import (
    match_descriptors_pair,
    match_descriptors_pair_auto,
    match_pairs_batch,
    matches_to_pairs,
)
from monocularsfm_tpu.ops.matching import match_descriptors_pair as jax_scan
from monocularsfm_tpu.ops.matching import match_pairs_batch as jax_batch
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


@pytest.mark.parametrize("cross_check", [True, False])
@pytest.mark.parametrize("n_a,n_b", [(512, 1024), (1024, 512)])
def test_pair_auto_takes_unequal_capacities_as_pallas(n_a, n_b, cross_check):
    """The single-pair matcher on CPU tensors with N_A != N_B against the
    reference's Pallas kernel (interpret mode), which reads the two sides'
    capacities apart."""
    rng = np.random.default_rng(5)
    da, db, ma, mb, _ = _planted_pair(rng, n=700, cap=1024, noise=0.06)
    da, ma, db, mb = da[:n_a], ma[:n_a], db[:n_b], mb[:n_b]
    pallas = np.asarray(match_descriptors_pair_pallas(
        *(jnp.asarray(x) for x in (da, db, ma, mb)), ratio=RATIO,
        max_distance=MAXD, cross_check=cross_check, row_tile=256,
        col_tile=256, interpret=True))
    match_kernel.reset_launches()
    ours = match_descriptors_pair_auto(*_t(da, db, ma, mb), ratio=RATIO,
                                       max_distance=MAXD,
                                       cross_check=cross_check).numpy()
    assert match_kernel.LAUNCHES["match_tile"] == 0  # CPU: plain version
    assert ours.shape == pallas.shape == (n_a,) and ours.dtype == np.int32
    assert (ours >= 0).sum() > 400 and ours.max() < n_b
    assert (ours == pallas).mean() >= AGREE
    for i in np.nonzero(ours != pallas)[0]:
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


def test_batch_equals_per_pair_results(ragged_bank):
    bank, mask = _t(*ragged_bank[:2])
    pairs = ragged_bank[2].tolist()
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


def _bank(rows):
    return torch.from_numpy(np.stack(rows))


@pytest.fixture(scope="module")
def ragged_bank():
    """Four images at capacity 1024 with 200-290 valid descriptors, noisy
    copies of one base set, and four pairs of them."""
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
    bank, mask = np.stack(bank), np.stack(mask)
    pairs = np.array([[0, 1], [2, 3], [1, 3], [3, 0]], np.int32)
    ref = np.asarray(jax_batch(jnp.asarray(bank), jnp.asarray(mask),
                               jnp.asarray(pairs), ratio=RATIO,
                               max_distance=MAXD, kernel="xla"))
    return bank, mask, pairs, ref


@pytest.mark.parametrize("kernel", ["auto", "pallas", "xla", True, False])
def test_match_pairs_batch_takes_the_reference_kernel_values(ragged_bank, kernel):
    """Every `kernel` value the reference takes (and the port's booleans)
    runs the plain statistics on CPU tensors and gives the reference's
    scan matcher's maps."""
    bank, mask, pairs, ref = ragged_bank
    match_kernel.reset_launches()
    ours = match_pairs_batch(*_t(bank, mask), pairs, ratio=RATIO,
                             max_distance=MAXD, kernel=kernel).numpy()
    assert match_kernel.LAUNCHES["match_tile"] == 0
    assert ours.shape == ref.shape == (4, 1024) and (ours >= 0).sum() > 400
    assert (ours == ref).mean() >= AGREE
    for k, i in zip(*np.nonzero(ours != ref)):
        ia, ib = pairs[k]
        assert _margin(bank[ia], bank[ib], mask[ia], mask[ib], i, True) < MARGIN


def test_match_pairs_batch_rejects_unknown_kernel(ragged_bank):
    bank, mask, pairs, _ = ragged_bank
    with pytest.raises(ValueError, match="kernel must be one of"):
        match_pairs_batch(*_t(bank, mask), pairs, kernel="triton")


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


@pytest.mark.parametrize("n_a,n_b", [(512, 256), (256, 640)])
def test_merged_rectangular_tile_partials_equal_plain_statistics(n_a, n_b):
    """Side A of capacity N_a, side B of N_b: the column partials are
    (P, N_a / 128, N_b) and merge to each pair's plain statistics, ties
    included."""
    rng = np.random.default_rng(n_a + n_b)
    da, db, ma, mb, _ = _planted_pair(rng, n=400, cap=640, noise=0.1)
    db[220:230] = db[200]          # exact duplicate columns: argmax ties
    da[150:160] = da[100]          # exact duplicate rows: column ties
    bank_a, mask_a = _bank([da[:n_a], db[:n_a]]), _bank([ma[:n_a], mb[:n_a]])
    bank_b, mask_b = _bank([db[:n_b], da[:n_b]]), _bank([mb[:n_b], ma[:n_b]])
    pairs = torch.tensor([[0, 0], [1, 1], [0, 1]], dtype=torch.int32)
    cols = match_kernel.column_partials_plain(bank_a, mask_a, pairs, bank_b, mask_b)
    assert all(c.shape == (3, n_a // 128, n_b) for c in cols)
    merged = match_kernel._merge_partials(*cols)
    for k, (ia, ib) in enumerate(pairs.tolist()):
        plain = match_kernel.match_stats_plain(bank_a[ia], bank_b[ib], mask_a[ia],
                                               mask_b[ib], col_tile=128)
        assert plain[0].shape == (n_a,) and plain[3].shape == (n_b,)
        for m, p in zip(merged, plain[3:]):
            assert torch.equal(m[k], p)


def _check_column_partials(bank, mask, pairs, bank_b, mask_b):
    """Block g of the partials holds the top-2 of rows 128 g .. 128 g + 127
    of A against every column of B, with global row indices; merged, they
    are the plain column statistics.  Returns the partials."""
    t1, i1, t2 = match_kernel.column_partials_plain(bank, mask, pairs, bank_b, mask_b)
    n_a, n_b = bank.shape[1], bank_b.shape[1]
    G = n_a // match_kernel.TILE
    assert t1.shape == i1.shape == t2.shape == (len(pairs), G, n_b)
    assert i1.dtype == torch.int32
    for k, (ia, ib) in enumerate(pairs.tolist()):
        a = bank[ia].to(torch.bfloat16).float()
        b = bank_b[ib].to(torch.bfloat16).float()
        sims = torch.where(mask[ia][:, None] & mask_b[ib][None, :], a @ b.T,
                           match_kernel.NEG)
        for g in range(G):
            blk = sims[128 * g:128 * (g + 1)]
            assert torch.equal(t1[k, g], blk.amax(0))
            assert torch.equal(i1[k, g], blk.argmax(0).int() + 128 * g)
            srt = blk.sort(0, descending=True).values
            assert torch.equal(t2[k, g], srt[1])
        merged = match_kernel._merge_partials(t1[k:k + 1], i1[k:k + 1], t2[k:k + 1])
        plain = match_kernel.match_stats_plain(bank[ia], bank_b[ib], mask[ia],
                                               mask_b[ib], col_tile=128)
        for m, p in zip(merged, plain[3:]):
            assert torch.equal(m[0], p)
    return t1, i1, t2


@pytest.mark.parametrize("cap", [128, 384])
def test_column_partials_layout(cap):
    """(P, N / 128, N) column partials of one bank: block g holds the top-2
    of rows 128 g .. 128 g + 127 with global row indices; masked rows and
    columns read NEG, a fully masked column gives the block's first row."""
    rng = np.random.default_rng(cap)
    bank = torch.from_numpy(rng.standard_normal((3, cap, 128)).astype(np.float32))
    mask = torch.from_numpy(rng.random((3, cap)) < 0.8)
    mask[2] = False
    pairs = torch.tensor([[0, 1], [2, 0], [1, 2]], dtype=torch.int32)
    t1, i1, t2 = _check_column_partials(bank, mask, pairs, bank, mask)
    assert torch.equal(match_kernel.column_partials_plain(bank, mask, pairs)[1], i1)
    G = cap // match_kernel.TILE
    assert (t1[1] == match_kernel.NEG).all() and (i1[1] == 128 * torch.arange(G)[:, None]).all()
    merged = match_kernel._merge_partials(t1, i1, t2)
    plain = match_kernel.match_stats_plain_batch(bank, mask, pairs, col_tile=128)
    for m, p in zip(merged, plain[3:]):
        assert torch.equal(m, p)


@pytest.mark.parametrize("n_a,n_b", [(384, 128), (128, 512)])
def test_column_partials_layout_rectangular(n_a, n_b):
    """The same layout with a B side of its own capacity: (P, N_a / 128,
    N_b); the fully masked image on side A gives NEG and each block's
    first row."""
    rng = np.random.default_rng(n_a * n_b)
    bank = torch.from_numpy(rng.standard_normal((3, n_a, 128)).astype(np.float32))
    mask = torch.from_numpy(rng.random((3, n_a)) < 0.8)
    mask[2] = False
    bank_b = torch.from_numpy(rng.standard_normal((2, n_b, 128)).astype(np.float32))
    mask_b = torch.from_numpy(rng.random((2, n_b)) < 0.8)
    pairs = torch.tensor([[0, 1], [2, 0], [1, 0]], dtype=torch.int32)
    t1, i1, _ = _check_column_partials(bank, mask, pairs, bank_b, mask_b)
    G = n_a // match_kernel.TILE
    assert (t1[1] == match_kernel.NEG).all() and (i1[1] == 128 * torch.arange(G)[:, None]).all()
