"""The port's pair-sharded and ring matching over gloo worlds of 2 and 3 CPU
ranks, against the port's per-pair results and the JAX package's sharded
matching on a mesh of the same size; and the brute matcher with a
ParallelConfig, rank 0 matching and verifying while rank 1 serves, against
the JAX package's sharded matcher (its F-RANSAC draws replayed)."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocularsfm_torch.ops.matching import match_descriptors_pair, match_pairs_batch
from monocularsfm_torch.parallel.mesh import spawn
from monocularsfm_tpu.parallel import make_mesh as jax_mesh
from monocularsfm_tpu.parallel import sharded_match_pairs as jax_sharded
from test_torch_matching import AGREE, MARGIN, _margin
from test_torch_scale_path import MATCH_AGREE
from test_torch_vocab import JaxMatchDraws, _scene_db

STEPS = "monocularsfm_torch.parallel.dryrun:"
CAP = 256
WORLD_TIMEOUT = 60.0
MATCHER = dict(min_num_matches_verified=15, ransac_iterations=256)
PAIR_BATCH = 8


def _bank(seed, n_img, noise):
    """n_img noisy copies of one descriptor set, 100-205 rows each."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(CAP, 128)).astype(np.float32)
    bank = np.zeros((n_img, CAP, 128), np.float32)
    mask = np.zeros((n_img, CAP), bool)
    for i in range(n_img):
        n = 100 + 21 * i
        v = base[:n] + noise * rng.normal(size=(n, 128)).astype(np.float32)
        bank[i, :n] = v / np.linalg.norm(v, axis=1, keepdims=True)
        mask[i, :n] = True
    return bank, mask


PAIRS = np.array([[i, j] for i in range(6) for j in range(i + 1, 6)],
                 np.int32)   # 15 pairs: padded on 2 ranks, not on 3


class _Recorder(JaxMatchDraws):
    """The JAX matcher's draws, kept in the order asked for."""

    def __init__(self):
        super().__init__()
        self.draws = []

    def __call__(self, shape):
        d = super().__call__(shape)
        self.draws.append(d.numpy())
        return d


@pytest.fixture(scope="module")
def matcher_dbs(tmp_path_factory):
    """One 8-view database copied four times (28 brute pairs, two groups of
    views, so cross-group pairs fail verification), and the draws the
    port asks for at a dispatch width of 2 x PAIR_BATCH, recorded from an
    unsharded port run of that width."""
    from monocularsfm_torch.config import MatchingConfig
    from monocularsfm_torch.features.matching import BruteFeatureMatcher

    root = tmp_path_factory.mktemp("sharded_matcher")
    _scene_db(str(root / "base.db"), np.random.default_rng(8), views=8)
    paths = {}
    for name in ("record", "jax", "torch"):
        paths[name] = root / f"{name}.db"
        shutil.copy(root / "base.db", paths[name])
    m = BruteFeatureMatcher(MatchingConfig(pair_batch=2 * PAIR_BATCH, **MATCHER),
                            device="cpu")
    m._draw = _Recorder()
    m.run_matching(str(paths["record"]), log=lambda *a: None)
    return paths, m._draw.draws


@pytest.fixture(scope="module")
def worlds(matcher_dbs):
    from monocularsfm_torch.config import MatchingConfig, ParallelConfig

    paths, draws = matcher_dbs
    bank, mask = _bank(3, 6, noise=0.05)
    ring_bank, ring_mask = _bank(4, 6, noise=0.05)
    out = {}
    for n in (2, 3):
        calls = [
            (STEPS + "match", (bank, mask, PAIRS, "cpu"), dict(col_tile=CAP)),
            (STEPS + "ring", (ring_bank, ring_mask, "cpu"),
             dict(cross_check=True, col_tile=CAP)),
            (STEPS + "ring", (ring_bank, ring_mask, "cpu"),
             dict(cross_check=False, col_tile=CAP)),
            (STEPS + "bank_query", (ring_bank[1], ring_mask[1], ring_bank,
                                    ring_mask, "cpu"), {}),
        ]
        if n == 2:
            calls.append((STEPS + "matcher", (
                str(paths["torch"]), MatchingConfig(pair_batch=PAIR_BATCH, **MATCHER),
                ParallelConfig(mesh_shape=(2,)), "cpu", draws), {}))
        out[n] = spawn(n, calls, timeout=WORLD_TIMEOUT)
    return (bank, mask), (ring_bank, ring_mask), out


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_pairs_equal_the_single_batch(worlds, n):
    (bank, mask), _, out = worlds
    ref = match_pairs_batch(torch.from_numpy(bank), torch.from_numpy(mask),
                            PAIRS, col_tile=CAP).numpy()
    assert (ref >= 0).sum() > 500
    for rank in out[n]:
        np.testing.assert_array_equal(rank[0]["idx"], ref)
        assert rank[0]["launches"] == 0      # the CPU runs the plain version


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_pairs_agree_with_jax_sharded(worlds, n):
    """JAX's sharded matcher on a mesh of n virtual devices; index maps to
    tests/test_torch_matching.py's rule: 99.9% equal, every difference on
    a tie within f32 summation noise."""
    (bank, mask), _, out = worlds
    ref = np.asarray(jax_sharded(jnp.asarray(bank), jnp.asarray(mask), PAIRS,
                                 jax_mesh(n), col_tile=CAP))
    ours = out[n][0][0]["idx"]
    assert (ours == ref).mean() >= AGREE
    for p, i in zip(*np.nonzero(ours != ref)):
        a, b = PAIRS[p]
        assert _margin(bank[a], bank[b], mask[a], mask[b], i, True) < MARGIN


def _direct(bank, mask, q, b, cross_check):
    ref = match_descriptors_pair(*(torch.from_numpy(x) for x in (
        bank[q], bank[b], mask[q], mask[b])), cross_check=cross_check,
        col_tile=CAP).numpy()
    i = np.nonzero(ref >= 0)[0]
    return np.stack([i, ref[i]], axis=1)


@pytest.mark.parametrize("cross_check", [True, False])
@pytest.mark.parametrize("n", [2, 3])
def test_ring_equals_direct_pairs(worlds, n, cross_check):
    """Even and odd rings (n = 2 meets its antipode both ways), with and
    without cross-check: every pair's rows equal the direct match, and
    every rank returns the same dict."""
    _, (bank, mask), out = worlds
    res = out[n][0][1 if cross_check else 2]["pairs"]
    total = 0
    for q in range(len(bank)):
        for b in range(len(bank)):
            if q == b or (cross_check and q > b):
                continue
            expected = _direct(bank, mask, q, b, cross_check)
            got = res.get((q, b), np.zeros((0, 2), np.int32))
            np.testing.assert_array_equal(got[np.argsort(got[:, 0])], expected,
                                          err_msg=f"{q},{b}")
            total += len(expected)
    assert total > 0
    for rank in out[n][1:]:
        other = rank[1 if cross_check else 2]["pairs"]
        assert other.keys() == res.keys()
        assert all(np.array_equal(other[k], res[k]) for k in res)


@pytest.mark.parametrize("n", [2, 3])
def test_bank_query_equals_direct_pairs(worlds, n):
    """ring_bank_matching: one replicated query against the bank sharded
    over the ranks equals the query matched against each image."""
    _, (ring_bank, ring_mask), out = worlds
    for rank in out[n]:
        got = rank[3]
        assert got.shape == (len(ring_bank), CAP)
        for i in range(len(ring_bank)):
            ref = match_descriptors_pair(*(torch.from_numpy(x) for x in (
                ring_bank[1], ring_bank[i], ring_mask[1], ring_mask[i])),
                col_tile=CAP)
            np.testing.assert_array_equal(got[i], ref.numpy())
    assert (out[n][0][3] >= 0).sum() > 100


def test_sharded_matcher_agrees_with_jax_sharded_matcher(worlds, matcher_dbs):
    """Rank 0 runs the brute matcher with ParallelConfig(mesh_shape=(2,)):
    each call matches 2 x pair_batch pairs over both ranks; F-RANSAC stays
    on rank 0.  The JAX package's matcher at mesh_shape=(2,) must write the
    same pairs and, per pair, the same matches to 99% (ROADMAP section 3);
    with the same draws, the unsharded port run of the same width writes
    exactly the same database."""
    from monocularsfm_torch.database import Database
    from monocularsfm_tpu.config import MatchingConfig as JC
    from monocularsfm_tpu.config import ParallelConfig as JP
    from monocularsfm_tpu.features.matching import BruteFeatureMatcher as JM

    paths, _ = matcher_dbs
    out = worlds[2][2]
    # The 12 pairs within a group of views reach verification.
    assert out[0][4]["written"] == 12 and out[1][4]["written"] is None
    JM(JC(pair_batch=PAIR_BATCH, **MATCHER), parallel=JP(mesh_shape=(2,))
       ).run_matching(str(paths["jax"]), log=lambda *a: None)
    got = {}
    for name in ("jax", "torch", "record"):
        db = Database(str(paths[name]))
        try:
            got[name] = db.read_all_matches()
        finally:
            db.close()
    mj, mt = got["jax"], got["torch"]
    assert mt.keys() == mj.keys()
    assert {p for p, m in mt.items() if len(m)} == {p for p, m in mj.items() if len(m)}
    for p in mj:
        a, b = set(map(tuple, mj[p])), set(map(tuple, mt[p]))
        if a or b:
            assert len(a & b) / max(len(a), len(b)) >= MATCH_AGREE, p
    assert got["torch"].keys() == got["record"].keys()
    for p in got["record"]:
        np.testing.assert_array_equal(got["torch"][p], got["record"][p])
