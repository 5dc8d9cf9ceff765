"""The two routes that a collection of more than a few dozen images takes,
the port against the JAX package on the CPU: sequential matching with an
overlap and the preemptive filter of the brute matcher (one database of
the port's features, the JAX matcher's F-RANSAC draws injected), and a
build whose global BA routes to PCG with split track rows."""

import shutil

import numpy as np
import pytest
import torch

from monocularsfm_torch.utils.synthetic import camera_ring_scene

from test_map_builder import scene_to_matches
from test_torch_map_builder import _config, _events, _trajectory_error
from test_torch_vocab import JaxMatchDraws

VIEWS, W, H = 5, 320, 240
OVERLAP = 2
MATCH_AGREE = 0.99
# 100 top-scale features per image and 20 matches: the filter keeps the
# near pairs of the 5-view arc and drops the far ones.
PREEMPTIVE = dict(is_preemptive=True, preemptive_num_features=100,
                  preemptive_min_num_matches=20)


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """The port's CPU work of this module on one thread: the test run's
    other workers hold the cores, and a pool of threads waiting on each
    other slows many small operations many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def feature_db(tmp_path_factory):
    """5 rendered 320x240 views of the multi-plane scene of the scale run
    (its focal cut with the width, a 40-degree arc), extracted by the
    port's SIFT on the CPU (a 1024-candidate octave budget keeps it quick).
    A planar scene would leave F-RANSAC's fundamental matrix
    ill-conditioned, so that f32 rounding could flip a match."""
    from monocularsfm_torch.database import Database
    from monocularsfm_torch.ops.sift import SIFT
    from monocularsfm_torch.utils.synthetic import render_multiplane_images

    imgs = render_multiplane_images(num_cameras=VIEWS, width=W, height=H,
                                    focal=275.0, arc_deg=40.0, scene_seed=7)[0]
    kps, descs = SIFT(num_features=1024, k_per_octave=1024,
                      device="cpu").extract_batch(imgs)
    path = tmp_path_factory.mktemp("scale_path") / "features.db"
    db = Database(str(path))
    for i, (k, d) in enumerate(zip(kps, descs)):
        iid = db.write_image(f"im{i:02d}.png")
        db.write_keypoints(iid, k)
        db.write_descriptors(iid, d)
    db.close()
    return path


def _match_both(feature_db, tmp_path, matcher, **kw):
    """Run each package's `matcher` on its own copy of the database; the
    verified match lists of each."""
    from monocularsfm_torch.config import MatchingConfig as TC
    from monocularsfm_torch.database import Database
    from monocularsfm_torch.features import matching as TM
    from monocularsfm_tpu.config import MatchingConfig as JC
    from monocularsfm_tpu.features import matching as JM

    quiet = lambda *a: None  # noqa: E731
    kw = dict(min_num_matches_verified=15, ransac_iterations=256, **kw)
    out = {}
    for name in ("jax", "torch"):
        path = tmp_path / f"{name}.db"
        shutil.copy(feature_db, path)
        if name == "jax":
            getattr(JM, matcher)(JC(**kw)).run_matching(str(path), log=quiet)
        else:
            m = getattr(TM, matcher)(TC(**kw), device="cpu")
            m._draw = JaxMatchDraws()
            m.run_matching(str(path), log=quiet)
        db = Database(str(path))
        try:
            out[name] = db.read_all_matches()
        finally:
            db.close()
    return out["jax"], out["torch"]


def _assert_same_matches(mj, mt):
    """The same pairs, the same verified pairs, and per pair the same
    matches up to MATCH_AGREE: with the same draws, two hypotheses whose
    inlier counts differ by one borderline match can swap as winner between
    the two packages' f32 arithmetic (as in test_torch_fundamental)."""
    assert set(mt) == set(mj)
    assert {p for p, m in mt.items() if len(m)} == {p for p, m in mj.items() if len(m)}
    for p in mj:
        a, b = set(map(tuple, mj[p])), set(map(tuple, mt[p]))
        agree = len(a & b) / max(len(a), len(b), 1)
        assert agree >= MATCH_AGREE, (p, len(a), len(b), agree)


def test_sequential_matcher_matches_reference(feature_db, tmp_path):
    mj, mt = _match_both(feature_db, tmp_path, "SequentialFeatureMatcher",
                         match_type="sequential", overlap=OVERLAP)
    _assert_same_matches(mj, mt)
    ids = range(1, VIEWS + 1)
    assert set(mt) == {(a, b) for a in ids for b in ids if 0 < b - a <= OVERLAP}
    assert all(len(mt[(a, a + 1)]) >= 15 for a in range(1, VIEWS))


def test_preemptive_filter_matches_reference(feature_db, tmp_path):
    mj, mt = _match_both(feature_db, tmp_path, "BruteFeatureMatcher",
                         **PREEMPTIVE)
    _assert_same_matches(mj, mt)
    exhaustive = VIEWS * (VIEWS - 1) // 2
    assert 0 < len(mt) < exhaustive                # the filter dropped pairs
    assert all((a, a + 1) in mt for a in range(1, VIEWS))


@pytest.fixture(scope="module")
def pcg_builds(tmp_path_factory):
    """The map-builder test's 6-camera scene, built by each package with
    dense_max_images 3 and track rows of width 2, so every global BA past
    the third image is the single-device PCG on split rows (the JAX build
    with its BA sharding off, so the test session's virtual devices do not
    route it to the mesh)."""
    from monocularsfm_torch import config as tc
    from monocularsfm_torch.reconstruction import MapBuilder as TB
    from monocularsfm_tpu import config as jc
    from monocularsfm_tpu.reconstruction import MapBuilder as JB

    root = tmp_path_factory.mktemp("pcg_builds")
    scene = camera_ring_scene(num_cameras=6, num_points=300, seed=21, arc_deg=100.0)
    keypoints, matches = scene_to_matches(scene)
    out = {}
    for name, B, mod in (("jax", JB, jc), ("torch", TB, tc)):
        cfg = _config(mod, scene)
        cfg.bundle.dense_max_images = 3
        cfg.bundle.track_width = 2
        if name == "jax":
            cfg.parallel.shard_ba = False
        b = B(cfg, **({"device": "cpu"} if name == "torch" else {}))
        b._log = lambda *a: None
        b.enable_metrics(root / f"{name}.jsonl")
        b.setup(matches, keypoints)
        out[name] = (b, b.do_build())
        b._metrics_fh.close()
    return scene, out, root


def test_pcg_build_matches_reference(pcg_builds):
    scene, out, root = pcg_builds
    (bj, sj), (bt, st) = out["jax"], out["torch"]
    assert sorted(bt.map.registered_ids) == sorted(bj.map.registered_ids)
    assert st.num_registered == scene.num_cameras
    assert abs(st.num_points3D - sj.num_points3D) <= 0.05 * sj.num_points3D
    assert abs(st.mean_reprojection_error - sj.mean_reprojection_error) <= 0.05
    for name in ("jax", "torch"):
        err = _trajectory_error(out[name][0], scene)
        assert err < 0.01, (name, err)
        gba = [e for e in _events(root / f"{name}.jsonl") if e["event"] == "global_ba"]
        assert any(e["solver"] == "pcg" and e["cams"] > 3 for e in gba), (name, gba)
        assert not any(e["sharded"] for e in gba), name
    solvers = lambda n: [(e["cams"], e["solver"])  # noqa: E731
                         for e in _events(root / f"{n}.jsonl") if e["event"] == "global_ba"]
    assert solvers("torch") == solvers("jax")
