"""The port's public functions that complete the JAX package's API, each
against its JAX counterpart on the same seeded inputs on the CPU: the
single-pair matcher, `project_points` and the two-view reprojection error,
`map_from_colmap` in both directions, `FeatureExtractor.extract_one`,
`TriangulatorStatistics`, the `VocabTreeFeatureMatcher` export and the
entry point's solve."""

import dataclasses
import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

from test_torch_scale_path import _one_cpu_thread  # noqa: F401
from test_torch_sift import PAIRED, _pair

REPO = pathlib.Path(__file__).resolve().parent.parent
RTOL = 1e-5          # f32 projections in another order of operations
POSE_TOL = XYZ_TOL = 1e-6
ENTRY_RTOL = 1e-4    # LM cost after 3 iterations (the smoke's card/CPU rule)


def _load(name):
    spec = importlib.util.spec_from_file_location(name, REPO / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the single-pair matcher ----------------------------------------------

def _auto_both(a, b, ma, mb):
    import jax.numpy as jnp

    from monocularsfm_torch.ops.matching import match_descriptors_pair_auto as T
    from monocularsfm_tpu.ops.matching import match_descriptors_pair_auto as J

    ref = np.asarray(J(jnp.asarray(a), jnp.asarray(b), jnp.asarray(ma),
                       jnp.asarray(mb)))
    ours = T(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(ma),
             torch.from_numpy(mb))
    assert ours.dtype == torch.int32 and ours.shape == (len(a),)
    return ref, ours.numpy()


@pytest.mark.parametrize("pair", [(0, 1), (3, 4)])
def test_pair_auto_equals_reference_on_bench_bank(pair, monkeypatch):
    """bench.py's descriptor recipe at capacity 1024, every row valid."""
    bench = _load("bench_torch")
    monkeypatch.setattr(bench, "MATCH_CAP", 1024)
    descs = bench._match_bank(5)
    mask = np.ones(1024, bool)
    ref, ours = _auto_both(descs[pair[0]], descs[pair[1]], mask, mask)
    assert (ref >= 0).mean() > 0.5
    np.testing.assert_array_equal(ours, ref)


def test_pair_auto_equals_reference_masked():
    """Padded capacity: zero rows past each image's count, masked out, and
    a few masked rows inside; one side has fewer valid rows."""
    rng = np.random.default_rng(7)
    cap = 1024
    base = rng.standard_normal((cap, 128)).astype(np.float32)
    a = base + 0.3 * rng.standard_normal(base.shape).astype(np.float32)
    b = base[rng.permutation(cap)] + 0.3 * rng.standard_normal(base.shape).astype(np.float32)
    for d in (a, b):
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    ma, mb = np.arange(cap) < 900, np.arange(cap) < 760
    ma &= rng.random(cap) > 0.05
    a[~ma] = 0
    b[~mb] = 0
    ref, ours = _auto_both(a, b, ma, mb)
    assert (ref >= 0).sum() > 100 and (ours[~ma] == -1).all()
    np.testing.assert_array_equal(ours, ref)


# -- projection -------------------------------------------------------------

def _pose_batch(rng, n):
    from monocularsfm_torch.geometry import angle_axis_to_matrix

    R = angle_axis_to_matrix(torch.from_numpy(
        rng.normal(scale=0.3, size=(n, 3)).astype(np.float32))).numpy()
    t = rng.normal(size=(n, 3)).astype(np.float32) + np.float32([0, 0, 6])
    return R, t


def test_project_points_and_two_view_error_equal_reference():
    import jax.numpy as jnp

    from monocularsfm_torch import geometry as TG
    from monocularsfm_torch.geometry import projection as TP
    from monocularsfm_tpu import geometry as JG
    from monocularsfm_tpu.geometry import projection as JP

    rng = np.random.default_rng(3)
    n = 200
    K = np.array([[900.0, 0, 512], [0, 880.0, 384], [0, 0, 1]], np.float32)
    R1, t1 = _pose_batch(rng, n)
    R2, t2 = _pose_batch(rng, n)
    X = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    uv1 = rng.uniform(0, 1024, size=(n, 2)).astype(np.float32)
    uv2 = rng.uniform(0, 768, size=(n, 2)).astype(np.float32)
    j = lambda *a: [jnp.asarray(x) for x in a]  # noqa: E731
    t = lambda *a: [torch.from_numpy(x) for x in a]  # noqa: E731

    ref = np.asarray(JG.project_points(*j(K, R1, t1, X)))
    ours = TG.project_points(*t(K, R1, t1, X)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=RTOL)
    args = (K, R1, t1, R2, t2, X, uv1, uv2)
    ref = np.asarray(JP.calculate_two_view_reprojection_error(*j(*args)))
    ours = TP.calculate_two_view_reprojection_error(*t(*args)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=RTOL)


# -- map_from_colmap ----------------------------------------------------------

def _scene_map(Map):
    """A 4-view map of a camera ring: every point visible in 2+ views, with
    keypoint colours, so each point's colour is its track's mean."""
    from monocularsfm_torch.utils.synthetic import camera_ring_scene

    scene = camera_ring_scene(num_cameras=4, num_points=60, seed=9, noise_px=0.3)
    rng = np.random.default_rng(9)
    m = Map(scene.K)
    for c in range(4):
        cols = rng.integers(0, 256, size=(scene.num_points, 3), dtype=np.uint8)
        m.load_image(c + 1, f"view{c}.png", scene.observations[c], cols)
        m.add_image_pose(c + 1, scene.R[c], scene.t[c])
    for p in range(scene.num_points):
        track = [(c + 1, p) for c in range(4) if scene.visible[c, p]]
        if len(track) >= 2:
            m.add_point3d(scene.points[p], track)
    return m


def _same_model(a, b):
    assert sorted(a.registered_ids) == sorted(b.registered_ids)
    for i in a.registered_ids:
        np.testing.assert_allclose(a.images[i].R, b.images[i].R, atol=POSE_TOL)
        np.testing.assert_allclose(a.images[i].t, b.images[i].t, atol=POSE_TOL)
        assert a.images[i].name == b.images[i].name
    pa, pb = a.point_ids(), b.point_ids()
    np.testing.assert_array_equal(pa, pb)
    assert len(pa) > 20
    for p in pa:
        np.testing.assert_allclose(a.xyz(p), b.xyz(p), atol=XYZ_TOL)
        assert a.track(p) == b.track(p)
        np.testing.assert_array_equal(a.color(p), b.color(p))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_map_from_colmap_equals_reference(writer, tmp_path):
    """A model written by one package is restored alike by both readers
    (poses, xyz, tracks and rgb), and the restored map equals the map that
    was written up to the model's precision."""
    from monocularsfm_torch.io.colmap import map_from_colmap as t_read
    from monocularsfm_torch.io.colmap import write_colmap as t_write
    from monocularsfm_torch.reconstruction.map_state import Map as TMap
    from monocularsfm_tpu.io.colmap import map_from_colmap as j_read
    from monocularsfm_tpu.io.colmap import write_colmap as j_write
    from monocularsfm_tpu.reconstruction.map_state import Map as JMap

    Map, write = (JMap, j_write) if writer == "jax" else (TMap, t_write)
    src = _scene_map(Map)
    write(src, tmp_path, width=1024, height=768)
    ours, ref = t_read(tmp_path), j_read(tmp_path)
    _same_model(ours, ref)
    np.testing.assert_allclose(ours.K, ref.K)
    for i in src.registered_ids:
        np.testing.assert_allclose(ours.images[i].t, src.images[i].t, atol=1e-12)
        np.testing.assert_allclose(ours.images[i].R, src.images[i].R, atol=1e-5)
    assert not ours.modified_point3D_ids
    ours.debug_check()


# -- extract_one ------------------------------------------------------------

@pytest.mark.parametrize("backend", ["jax", "opencv"])
def test_extract_one_equals_reference(backend):
    """A 320x240 colour render cut to max_image_size 160: the JAX package's
    keypoint count, and 99% of its keypoints within KP_TOL in original
    coordinates with their colours.  The default backend runs a small SIFT
    (512 features, 512 candidates per octave) in both packages."""
    from monocularsfm_torch.config import ExtractionConfig as TC
    from monocularsfm_torch.features.extraction import FeatureExtractor as TE
    from monocularsfm_torch.ops.sift import SIFT as TS
    from monocularsfm_torch.utils.synthetic import render_textured_images
    from monocularsfm_tpu.config import ExtractionConfig as JC
    from monocularsfm_tpu.features.extraction import FeatureExtractor as JE
    from monocularsfm_tpu.ops.sift import SIFT as JS

    if backend == "opencv":
        pytest.importorskip("cv2")
    chans = [render_textured_images(num_cameras=1, width=320, height=240,
                                    scene_seed=s)[0][0] for s in (5, 6, 7)]
    bgr = np.stack(chans[::-1], -1)
    gray = chans[1]
    kw = dict(max_image_size=160, num_features=512, backend=backend)
    je, te = JE(JC(**kw)), TE(TC(**kw), device="cpu")
    if backend == "jax":
        je._sift = JS(num_features=512, k_per_octave=512)
        te._sift = TS(num_features=512, k_per_octave=512, device="cpu")
    kj, cj, dj = je.extract_one(gray, bgr)
    kt, ct, dt = te.extract_one(gray, bgr)
    assert len(kj) > 100 and len(kt) == len(kj)
    assert kt.shape == (len(kt), 4) and dt.shape == (len(kt), 128)
    assert ct.dtype == np.uint8 and ct.shape == (len(kt), 3)
    assert kj[:, 0].max() > 160                   # back in original coordinates
    j = _pair(kj, kt)
    ok = j >= 0
    assert ok.mean() >= PAIRED
    np.testing.assert_array_equal(ct[j[ok]], cj[ok])
    none = te.extract_one(gray)[1]
    assert none.shape == (len(kt), 3) and not none.any()


# -- small public names -------------------------------------------------------

def test_triangulator_statistics_and_exports_match_reference():
    from monocularsfm_torch import features as TF
    from monocularsfm_torch import geometry as TG
    from monocularsfm_torch.features.matching import VocabTreeFeatureMatcher
    from monocularsfm_torch.reconstruction.triangulator import (
        TriangulatorStatistics as T,
    )
    from monocularsfm_tpu import features as JF
    from monocularsfm_tpu import geometry as JG
    from monocularsfm_tpu.reconstruction.triangulator import (
        TriangulatorStatistics as J,
    )

    assert ([(f.name, f.type) for f in dataclasses.fields(T)]
            == [(f.name, f.type) for f in dataclasses.fields(J)])
    t, j = T(), J()
    assert (t.num_tried, t.num_triangulated) == (j.num_tried, j.num_triangulated) == (0, 0)
    assert math.isnan(t.ave_residual) and math.isnan(j.ave_residual)
    assert TF.VocabTreeFeatureMatcher is VocabTreeFeatureMatcher
    assert set(TF.__all__) == set(JF.__all__)
    assert set(TG.__all__) == set(JG.__all__)


# -- entry --------------------------------------------------------------------

def test_entry_cpu_equals_reference_entry():
    """`entry("cpu")`'s solve against `__graft_entry__.entry()`'s jitted
    one: the same iterations, cost_final within ENTRY_RTOL."""
    import jax

    from monocularsfm_torch import entry as E
    from monocularsfm_torch.parallel.dryrun import dryrun_multichip

    graft = _load("__graft_entry__")
    jfn, jargs = graft.entry()
    ref = jax.jit(jfn)(*jargs)
    fn, args = E.entry("cpu")
    assert args[0].R.device.type == "cpu"
    out = fn(*args)
    assert out["iterations"] == int(ref["iterations"]) == 3
    c_ref, c_ours = float(ref["cost_final"]), float(out["cost_final"])
    assert c_ours < float(out["cost_initial"])
    assert abs(c_ours - c_ref) <= ENTRY_RTOL * c_ref, (c_ours, c_ref)
    assert E.dryrun_multichip is dryrun_multichip


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is visible")
def test_entry_defaults_to_cuda_and_raises_without_a_card():
    from monocularsfm_torch import entry as E

    with pytest.raises(RuntimeError, match="cuda"):
        E.entry()
    with pytest.raises(RuntimeError, match="cuda"):
        E.tiny_problem()
