"""The port's visual vocabulary (k-means, quantization, TF-IDF, retrieval)
and its VocabTreeFeatureMatcher against the JAX package's, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocularsfm_torch.ops import vocab as TV
from monocularsfm_tpu.ops import vocab as JV

CENTROID_TOL = 1e-5     # f32 means of unit vectors, sums in another order
TFIDF_TOL = 1e-6


def _unit(rng, n, d=128):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _clusters(rng, k=6, per=200, noise=0.05):
    """k well-separated clusters of unit descriptors, and their centres."""
    centers = _unit(rng, k)
    desc = np.concatenate([c + noise * rng.normal(size=(per, 128)).astype(np.float32)
                           for c in centers])
    return desc / np.linalg.norm(desc, axis=1, keepdims=True), centers


def _bank(rng, centers, clusters, cap=256, n=150):
    """One image per entry of `clusters`: n descriptors, 60% from that
    cluster and the rest from any, padded to cap."""
    bank = np.zeros((len(clusters), cap, 128), np.float32)
    mask = np.zeros((len(clusters), cap), bool)
    for i, c in enumerate(clusters):
        label = np.where(rng.random(n) < 0.6, c, rng.integers(0, len(centers), n))
        d = centers[label] + 0.05 * rng.normal(size=(n, 128)).astype(np.float32)
        bank[i, :n] = d / np.linalg.norm(d, axis=1, keepdims=True)
        mask[i, :n] = True
    return bank, mask


@pytest.fixture(scope="module")
def vocabs():
    rng = np.random.default_rng(0)
    desc, centers = _clusters(rng)
    j = JV.train_visual_vocab(desc, num_words=64, iterations=8)
    t = TV.train_visual_vocab(desc, num_words=64, iterations=8).numpy()
    return desc, centers, j, t


def test_kmeans_centroids_match_reference(vocabs):
    """The same subsample and initial words (np.random.default_rng(seed)),
    then Lloyd steps with index_add_ for segment_sum."""
    desc, _, j, t = vocabs
    assert t.shape == (64, 128)
    np.testing.assert_allclose(t, j, atol=CENTROID_TOL)
    np.testing.assert_allclose(np.linalg.norm(t, axis=1), 1.0, atol=1e-5)
    # A collection over max_train: the same subsample in both packages.
    jj = JV.train_visual_vocab(desc, num_words=32, iterations=3, max_train=700, seed=4)
    tt = TV.train_visual_vocab(desc, num_words=32, iterations=3, max_train=700, seed=4)
    np.testing.assert_allclose(tt.numpy(), jj, atol=CENTROID_TOL)
    with pytest.raises(ValueError, match="training descriptors"):
        TV.train_visual_vocab(desc[:10], num_words=64)


def test_histograms_tfidf_and_retrieval_match_reference(vocabs):
    _, centers, vocab, _ = vocabs
    vocab = np.array(vocab)                                # writable copy
    rng = np.random.default_rng(1)
    bank, mask = _bank(rng, centers, [0, 0, 1, 1, 2, 3, 3, 5])
    hj = np.asarray(JV.quantize_batch(jnp.asarray(bank), jnp.asarray(mask),
                                      jnp.asarray(vocab), 64))
    ht = TV.quantize_batch(torch.from_numpy(bank), torch.from_numpy(mask),
                           torch.from_numpy(vocab), 64)
    np.testing.assert_array_equal(ht.numpy(), hj)
    assert ht.sum(1).tolist() == [150.0] * len(bank)        # padding counts zero
    one = TV.quantize(torch.from_numpy(bank[3]), torch.from_numpy(mask[3]),
                      torch.from_numpy(vocab), 64)
    np.testing.assert_array_equal(one.numpy(), hj[3])

    sj = np.array(JV.tfidf_signatures(jnp.asarray(hj)))
    st = TV.tfidf_signatures(ht)
    np.testing.assert_allclose(st.numpy(), sj, atol=TFIDF_TOL)

    scores_j, idx_j = (np.asarray(a) for a in JV.retrieve_top_k(jnp.asarray(sj), 3))
    scores_t, idx_t = TV.retrieve_top_k(torch.from_numpy(sj), 3)
    full = sj @ sj.T
    np.fill_diagonal(full, -np.inf)
    srt = -np.sort(-full, axis=1)
    assert (np.diff(srt[:, :4], axis=1) < 0).all()         # distinct scores
    np.testing.assert_array_equal(idx_t.numpy(), idx_j)
    np.testing.assert_allclose(scores_t.numpy(), scores_j, atol=TFIDF_TOL)
    partner = {0: 1, 1: 0, 2: 3, 3: 2, 5: 6, 6: 5}
    for i, j in partner.items():
        assert idx_t[i, 0].item() == j


def test_retrieval_breaks_ties_to_the_lower_index():
    """Exact ties: jax.lax.top_k's order, the lower index first."""
    sig = torch.tensor([[1.0, 0.0], [1.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 0.0]])
    _, idx_t = TV.retrieve_top_k(sig, 4)
    _, idx_j = JV.retrieve_top_k(jnp.asarray(sig.numpy()), 4)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    assert idx_t[0].tolist() == [1, 2, 4, 3]


class JaxMatchDraws:
    """Stands in for the matcher's `_draw`: the uniforms the JAX matcher,
    seeded with 1234, draws inside F-RANSAC (split per round, split per
    pair, then uniform)."""

    def __init__(self):
        self.key = jax.random.PRNGKey(1234)

    def __call__(self, shape):
        B, M, N = shape
        self.key, k = jax.random.split(self.key)
        return torch.from_numpy(np.stack(
            [np.asarray(jax.random.uniform(kk, (M, N)))
             for kk in jax.random.split(k, B)]))


def _scene_db(path, rng, views=6, n=300):
    """A database of `views` images in two groups (0-2 see scene A, 3-5
    scene B): each group's descriptors are noisy copies of its scene's, and
    its keypoints views of one plane under a small homography, so a group's
    pairs verify and cross-group pairs do not."""
    from monocularsfm_torch.database import Database

    scenes = [_unit(rng, n), _unit(rng, n)]
    base_uv = rng.uniform(20, 600, size=(n, 2))
    db = Database(path)
    for i in range(views):
        g = i // (views // 2)
        d = scenes[g] + 0.03 * rng.normal(size=(n, 128)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        H = np.eye(3) + np.array([[0.01 * i, 0.02, 3.0 * i], [-0.01, 0.015 * i, -2.0 * i],
                                  [1e-5 * i, 0, 0]])
        p = np.c_[base_uv, np.ones(n)] @ H.T
        uv = (p[:, :2] / p[:, 2:]).astype(np.float32)
        kp = np.c_[uv, np.full((n, 1), 2.0), np.zeros((n, 1))].astype(np.float32)
        iid = db.write_image(f"im{i}.png")
        db.write_keypoints(iid, kp)
        db.write_descriptors(iid, d)
    db.close()


def _matches(path):
    from monocularsfm_torch.database import Database

    db = Database(path)
    try:
        return {p: m for p, m in db.read_all_matches().items()}
    finally:
        db.close()


def test_vocab_matcher_matches_reference_end_to_end(tmp_path):
    """One database, matched by each package's VocabTreeFeatureMatcher with
    the reference's F-RANSAC draws injected: the same retrieved pairs and the
    same verified match lists (as tests/test_matching.py:220 for the JAX
    matcher)."""
    import shutil

    from monocularsfm_torch.config import MatchingConfig as TC
    from monocularsfm_torch.features.matching import VocabTreeFeatureMatcher as TM
    from monocularsfm_tpu.config import MatchingConfig as JC
    from monocularsfm_tpu.features.matching import VocabTreeFeatureMatcher as JM

    _scene_db(tmp_path / "t.db", np.random.default_rng(2))
    shutil.copy(tmp_path / "t.db", tmp_path / "j.db")
    kw = dict(vocab_num_words=64, vocab_num_neighbors=2,
              min_num_matches_verified=15, ransac_iterations=256)
    quiet = lambda *a: None  # noqa: E731
    JM(JC(**kw)).run_matching(str(tmp_path / "j.db"), log=quiet)
    m = TM(TC(**kw), device="cpu")
    m._draw = JaxMatchDraws()
    m.run_matching(str(tmp_path / "t.db"), log=quiet)
    mj, mt = _matches(tmp_path / "j.db"), _matches(tmp_path / "t.db")
    assert set(mt) == set(mj)
    assert len(mt) < 6 * 5 // 2                            # fewer than exhaustive
    for p in mj:
        np.testing.assert_array_equal(mt[p], mj[p])
    verified = {p for p, v in mt.items() if len(v)}
    assert (1, 2) in verified and (4, 5) in verified
    assert all((a <= 3) == (b <= 3) for a, b in verified)  # within a group
