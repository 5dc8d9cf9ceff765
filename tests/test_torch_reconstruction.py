"""The port's reconstruction engines, native core and BA bridge against the
JAX package's, on the CPU, with the reference's RANSAC draws injected."""

import jax
import numpy as np
import pytest
import torch

from monocularsfm_torch import native
from monocularsfm_torch.reconstruction import Map as TMap, SceneGraph as TGraph
from monocularsfm_torch.utils.synthetic import camera_ring_scene

POSE_TOL = 1e-4


class JaxDraws:
    """Stands in for an engine's `_draw`: the uniforms the reference engine
    seeded with `seed` draws in the same order (split, then uniform)."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, m, n):
        self.key, k = jax.random.split(self.key)
        return torch.from_numpy(np.array(jax.random.uniform(k, (m, n))))


def _make_state(seed=0, num_cameras=6, num_points=300, register=(0, 1, 2),
                pkg="torch"):
    """The state of tests/test_native.py, in either package."""
    if pkg == "torch":
        Map, SceneGraph = TMap, TGraph
    else:
        from monocularsfm_tpu.reconstruction import Map, SceneGraph
    scene = camera_ring_scene(num_cameras=num_cameras, num_points=num_points, seed=seed)
    keypoints, kpt_of = {}, {}
    for c in range(num_cameras):
        vis = np.nonzero(scene.visible[c])[0]
        keypoints[c] = scene.observations[c][vis].astype(np.float32)
        inv = np.full(num_points, -1, np.int64)
        inv[vis] = np.arange(len(vis))
        kpt_of[c] = inv
    matches = {}
    for i in range(num_cameras):
        for j in range(i + 1, num_cameras):
            common = np.nonzero(scene.visible[i] & scene.visible[j])[0]
            if len(common) >= 10:
                matches[(i, j)] = np.stack(
                    [kpt_of[i][common], kpt_of[j][common]], 1).astype(np.int32)
    g = SceneGraph().load(matches, {c: len(keypoints[c]) for c in keypoints})

    def build_map(use_native):
        m = Map(scene.K)
        for c in range(num_cameras):
            m.load_image(c, f"im{c}", keypoints[c])
        m.attach_scene_graph(g, use_native=use_native)
        for c in register:
            m.add_image_pose(c, scene.R[c], scene.t[c])
        pairs = g.find_correspondences_between_images(0, 1)
        for row in range(0, len(pairs), 3):
            k0, k1 = int(pairs[row, 0]), int(pairs[row, 1])
            if m.images[0].point3D[k0] >= 0 or m.images[1].point3D[k1] >= 0:
                continue
            p_world = np.nonzero(kpt_of[0] == k0)[0][0]
            m.add_point3d(scene.points[p_world], [(0, k0), (1, k1)])
        return m

    return build_map, scene


def test_native_core_builds_under_build_dir():
    lib = native.get_lib()
    assert native.available() and lib is native.get_lib()
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.SRC.name == "scene_graph_core.cpp"


@pytest.mark.parametrize("case", ["get_2d3d", "triangulation_tracks", "complete", "merge"])
def test_native_track_maintenance_equals_numpy(case):
    if case in ("get_2d3d", "triangulation_tracks"):
        build_map, _ = _make_state()
    else:
        build_map, _ = _make_state(seed=7, num_cameras=8, num_points=400,
                                   register=tuple(range(8)))
    m_nat, m_py = build_map(True), build_map(False)
    assert m_nat._native is not None and m_py._native is None
    if case == "get_2d3d":
        for image_id in (2, 3, 4):
            for a, b in zip(m_nat.get_2d3d(image_id), m_py.get_2d3d(image_id)):
                np.testing.assert_array_equal(a, b)
    elif case == "triangulation_tracks":
        for image_id in (1, 2):
            tr_n = m_nat.get_triangulation_tracks(image_id)
            tr_p = m_py.get_triangulation_tracks(image_id)
            assert [k for k, _ in tr_n] == [k for k, _ in tr_p]
            assert [set(t) for _, t in tr_n] == [set(t) for _, t in tr_p]
    else:
        pids = [int(p) for p in m_nat.point_ids()]
        n_c = (m_nat.complete_points(pids, max_error_px=4.0),
               m_py.complete_points(pids, max_error_px=4.0))
        assert n_c[0] == n_c[1]
        if case == "merge":
            n_m = [m.merge_points([p for p in pids if m._alive[p]], max_error_px=4.0)
                   for m in (m_nat, m_py)]
            assert n_m[0] == n_m[1]

        def partition(m):
            return sorted(tuple(sorted(m.track(int(p)))) for p in m.point_ids())

        assert partition(m_nat) == partition(m_py)
        m_nat.debug_check()


@pytest.mark.parametrize("split", [False, True])
def test_ba_problem_bridge_equals_reference_exactly(split):
    build_t, _ = _make_state(seed=7, num_cameras=8, num_points=400,
                             register=tuple(range(8)))
    build_j, _ = _make_state(seed=7, num_cameras=8, num_points=400,
                             register=tuple(range(8)), pkg="jax")
    mt, mj = build_t(False), build_j(False)
    for m in (mt, mj):
        m.complete_points([int(p) for p in m.point_ids()], max_error_px=4.0)
    for get in (lambda m: m.get_global_ba_data(track_width=2, allow_split=split),
                lambda m: m.get_local_ba_data(3, allow_split=split, track_width=2)):
        pt, ids_t, pids_t = get(mt)
        pj, ids_j, pids_j = get(mj)
        assert ids_t == ids_j and pids_t == pids_j
        for name, v in pt.tensors().items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(getattr(pj, name)),
                                          err_msg=name)
        assert (pt.point_rows is None) == (pj.point_rows is None) == (not split)


def _pair_correspondences(planar, seed=11, n=400):
    """Two views of a point blob (the F path) or of a plane (the H path),
    0.5 px noise, 10% outliers.  Returns (K, uv1, uv2)."""
    rng = np.random.default_rng(seed)
    if planar:
        K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
        X = np.c_[rng.uniform(-2, 2, (n, 2)), np.full(n, 6.0)]
        c, s_ = np.cos(0.12), np.sin(0.12)
        R2 = np.array([[c, 0, -s_], [0, 1, 0], [s_, 0, c]])
        t2 = np.array([1.0, 0.05, 0.1])
        uv = [(x / x[:, 2:]) @ K.T for x in (X, X @ R2.T + t2)]
        uv1, uv2 = (u[:, :2] + rng.normal(scale=0.5, size=(n, 2)) for u in uv)
        size = (640, 480)
    else:
        scene = camera_ring_scene(num_cameras=2, num_points=n, noise_px=0.5,
                                  seed=seed, arc_deg=40.0)
        K, size = scene.K, (scene.width, scene.height)
        uv1 = scene.observations[0].copy()
        uv2 = scene.observations[1].copy()
    bad = rng.random(n) < 0.1
    uv2[bad] = rng.uniform(0, size, (bad.sum(), 2))
    return K, uv1, uv2


def _cfg(module_config):
    cfg = module_config.InitializerConfig()
    cfg.ransac_iterations = 256
    return cfg


@pytest.mark.parametrize("planar", [False, True])
def test_initializer_matches_reference_with_injected_draws(planar):
    from monocularsfm_torch import config as tc
    from monocularsfm_torch.reconstruction.initializer import Initializer as TI
    from monocularsfm_tpu import config as jc
    from monocularsfm_tpu.reconstruction.initializer import Initializer as JI

    K, uv1, uv2 = _pair_correspondences(planar)
    ref = JI(K, _cfg(jc)).initialize(uv1, uv2)
    init = TI(K, _cfg(tc), device="cpu")
    init._draw = JaxDraws(42)
    out = init.initialize(uv1, uv2)
    sj, so = ref[0], out[0]
    assert so.is_succeed and sj.is_succeed and so.method == sj.method
    assert so.method == ("homography" if planar else "fundamental")
    assert so.num_inliers == sj.num_inliers
    np.testing.assert_array_equal(out[4], ref[4])
    np.testing.assert_allclose(out[1], ref[1], atol=POSE_TOL)
    np.testing.assert_allclose(out[2], ref[2], atol=POSE_TOL)
    np.testing.assert_allclose(out[3], ref[3], rtol=1e-3, atol=1e-3)
    assert abs(so.ave_residual - sj.ave_residual) <= 0.01     # px


def test_registrant_matches_reference_with_injected_draws():
    from monocularsfm_torch import config as tc
    from monocularsfm_torch.reconstruction.registrant import Registrant as TR
    from monocularsfm_tpu import config as jc
    from monocularsfm_tpu.reconstruction.registrant import Registrant as JR

    scene = camera_ring_scene(num_cameras=3, num_points=500, noise_px=0.5, seed=5)
    rng = np.random.default_rng(5)
    vis = scene.visible[2]
    xyz = scene.points[vis] + rng.normal(scale=0.005, size=(vis.sum(), 3))
    uv = scene.observations[2][vis].copy()
    bad = rng.random(len(uv)) < 0.2
    uv[bad] = rng.uniform(0, [scene.width, scene.height], (bad.sum(), 2))
    cfgs = []
    for mod in (jc, tc):
        c = mod.RegistrantConfig()
        c.ransac_iterations = 256
        cfgs.append(c)
    ref = JR(scene.K, cfgs[0]).register(xyz, uv)
    reg = TR(scene.K, cfgs[1], device="cpu")
    reg._draw = JaxDraws(7)
    out = reg.register(xyz, uv)
    assert out[0].is_succeed and ref[0].is_succeed
    assert out[0].num_inliers == ref[0].num_inliers
    np.testing.assert_array_equal(out[3], ref[3])
    np.testing.assert_allclose(out[1], ref[1], atol=POSE_TOL)
    np.testing.assert_allclose(out[2], ref[2], atol=POSE_TOL)
    assert abs(out[0].ave_residual - ref[0].ave_residual) <= 1e-3
    # P3P on the same correspondences (tests/test_torch_pnp.py holds every
    # method).
    for c in cfgs:
        c.pnp_method = "p3p"
    ref = JR(scene.K, cfgs[0]).register(xyz, uv)
    reg = TR(scene.K, cfgs[1], device="cpu")
    reg._draw = JaxDraws(7)
    out = reg.register(xyz, uv)
    assert out[0].is_succeed and out[0].num_inliers == ref[0].num_inliers
    np.testing.assert_array_equal(out[3], ref[3])
    np.testing.assert_allclose(out[1], ref[1], atol=POSE_TOL)
    np.testing.assert_allclose(out[2], ref[2], atol=POSE_TOL)


def test_triangulator_matches_reference():
    from monocularsfm_torch.reconstruction.triangulator import Triangulator as TT
    from monocularsfm_tpu.reconstruction.triangulator import Triangulator as JT

    scene = camera_ring_scene(num_cameras=6, num_points=300, noise_px=0.4, seed=9)
    rng = np.random.default_rng(9)
    poses = {c: (scene.R[c], scene.t[c]) for c in range(6)}
    tracks = []
    for p in range(300):
        cams = np.nonzero(scene.visible[:, p])[0]
        uv = [scene.observations[c, p].copy() for c in cams]
        if p % 7 == 0 and len(uv) > 1:
            uv[-1] = uv[-1] + 20.0                # a bad view -> rejected
        tracks.append(list(zip(cams.tolist(), uv)))
    tracks += [[(0, rng.uniform(0, 500, 2))]]     # one single-view track
    Xj, aj, ej = JT(scene.K, batch_cap=128).triangulate_tracks(tracks, poses)
    Xt, at, et = TT(scene.K, batch_cap=128, device="cpu").triangulate_tracks(tracks, poses)
    np.testing.assert_array_equal(at, aj)
    assert 0.5 < at.mean() < 1.0
    np.testing.assert_allclose(Xt[at], Xj[aj], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(et, ej, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("module,name", [("initializer", "Initializer"),
                                         ("registrant", "Registrant"),
                                         ("triangulator", "Triangulator")])
def test_engines_default_to_the_card(module, name, monkeypatch):
    """Like every entry point of the port, an engine runs on the card unless
    the caller asks for the CPU, and raises where there is no card."""
    import importlib

    cls = getattr(importlib.import_module(
        f"monocularsfm_torch.reconstruction.{module}"), name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        cls(np.eye(3))
    assert cls(np.eye(3), device="cpu").device == torch.device("cpu")
