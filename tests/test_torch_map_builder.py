"""The whole reconstruct slice: the port's MapBuilder against the JAX
package's on the same synthetic correspondences, on the CPU.  Each package
draws its own RANSAC uniforms, as a user's run does.  Both builds also
write the JSON-lines event log (`enable_metrics`) and the MONOSFM_DUMP_BA
snapshot; the port's profiler trace and visualization have tests of their
own below."""

import json

import numpy as np
import pytest

from monocularsfm_torch.utils.synthetic import camera_ring_scene, similarity_align

from test_map_builder import scene_to_matches


def _config(module_config, scene):
    cfg = module_config.SfMConfig()
    cfg.camera.fx, cfg.camera.fy = scene.K[0, 0], scene.K[1, 1]
    cfg.camera.cx, cfg.camera.cy = scene.K[0, 2], scene.K[1, 2]
    return cfg


def _trajectory_error(builder, scene):
    m = builder.map
    ids = sorted(m.registered_ids)
    est = np.array([-m.images[i].R.T @ m.images[i].t for i in ids])
    gt = np.array([-scene.R[i].T @ scene.t[i] for i in ids])
    _, rms = similarity_align(est, gt)
    return rms / np.linalg.norm(gt - gt.mean(0), axis=1).mean()


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    from monocularsfm_torch import config as tc
    from monocularsfm_torch.reconstruction import MapBuilder as TB
    from monocularsfm_tpu import config as jc
    from monocularsfm_tpu.reconstruction import MapBuilder as JB

    root = tmp_path_factory.mktemp("builds")
    scene = camera_ring_scene(num_cameras=6, num_points=300, seed=21, arc_deg=100.0)
    keypoints, matches = scene_to_matches(scene)
    quiet = lambda *a: None  # noqa: E731
    out = {}
    for name, B, mod in (("jax", JB, jc), ("torch", TB, tc)):
        kw = {"device": "cpu"} if name == "torch" else {}
        b = B(_config(mod, scene), **kw)
        b._log = quiet
        b.enable_metrics(root / f"{name}.jsonl")
        b.setup(matches, keypoints)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("MONOSFM_DUMP_BA", str(root / f"{name}_ba.npz"))
            out[name] = (b, b.do_build())
        b._metrics_fh.close()
    return scene, out, root


def test_same_registered_set(builds):
    scene, out, _ = builds
    (bj, sj), (bt, st) = out["jax"], out["torch"]
    assert sorted(bt.map.registered_ids) == sorted(bj.map.registered_ids)
    assert st.num_registered == scene.num_cameras


def test_points_and_reprojection_agree(builds):
    _, out, _ = builds
    sj, st = out["jax"][1], out["torch"][1]
    assert abs(st.num_points3D - sj.num_points3D) <= 0.05 * sj.num_points3D
    assert abs(st.mean_reprojection_error - sj.mean_reprojection_error) <= 0.05
    assert st.mean_reprojection_error < 1.0


def test_trajectories_within_one_percent(builds):
    scene, out, _ = builds
    for name in ("jax", "torch"):
        err = _trajectory_error(out[name][0], scene)
        assert err < 0.01, (name, err)


def _events(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_metrics_log_matches_reference(builds):
    """The same events in the same order with the same fields; the counts,
    the registered images and the solvers equal, inliers within 5% (each
    package draws its own RANSAC uniforms)."""
    _, out, root = builds
    ej, et = _events(root / "jax.jsonl"), _events(root / "torch.jsonl")
    assert [e["event"] for e in et] == [e["event"] for e in ej]
    n_reg = len(out["torch"][0].map.registered_ids)
    assert sum(e["event"] == "register" for e in et) == n_reg - 2
    assert any(e["event"] == "global_ba" for e in et)
    for a, b in zip(et, ej):
        assert sorted(a) == sorted(b)
        assert a["num_registered"] == b["num_registered"]
        if a["event"] == "register":
            assert a["image_id"] == b["image_id"]
            assert abs(a["inliers"] - b["inliers"]) <= 0.05 * b["inliers"]
        else:
            # The JAX build shards its BA over the test run's eight virtual
            # CPU devices; the port has no sharded BA yet.
            for k in ("cams", "solver"):
                assert a[k] == b[k], k
            assert a["sharded"] is False


def test_ba_dump_matches_reference(builds):
    """MONOSFM_DUMP_BA: the last global-BA problem, the same arrays (names,
    shapes; dtypes up to the port's int64 indices) and solver arguments."""
    _, _, root = builds
    with np.load(root / "jax_ba.npz") as zj, np.load(root / "torch_ba.npz") as zt:
        assert sorted(zt.files) == sorted(zj.files)
        for k in zj.files:
            assert zt[k].shape == zj[k].shape, k
            assert zt[k].dtype.kind == zj[k].dtype.kind, k
        assert json.loads(str(zt["_kwargs"])) == json.loads(str(zj["_kwargs"]))


def test_profile_dir_and_visualization(tmp_path):
    """`profile_dir` writes a Chrome trace of the build; `is_visualization`
    writes the viewer's artifacts under output_path/viz for the final map."""
    from monocularsfm_torch import config as tc
    from monocularsfm_torch.reconstruction import MapBuilder as TB

    scene = camera_ring_scene(num_cameras=4, num_points=150, seed=3, arc_deg=60.0)
    keypoints, matches = scene_to_matches(scene)
    cfg = _config(tc, scene)
    cfg.output_path = str(tmp_path / "out")
    cfg.map_builder.profile_dir = str(tmp_path / "prof")
    cfg.map_builder.is_visualization = True
    b = TB(cfg, device="cpu")
    b._log = lambda *a: None
    b.setup(matches, keypoints)
    summary = b.do_build()
    assert summary.num_registered == 4
    trace = json.loads((tmp_path / "prof" / "mapbuilder_trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("aten::" in n for n in names)
    viz = tmp_path / "out" / "viz"
    state = json.loads((viz / "state.json").read_text())
    assert state["num_points"] == summary.num_points3D
    assert len(state["cams"]) == 4
    assert f"element vertex {summary.num_points3D}" in (viz / "live.ply").read_text()
    assert (viz / "viewer.html").exists()


def test_async_viz_artifacts_equal_reference(tmp_path):
    """Both packages' AsyncVisualization on the same map write the same
    files (tests/test_focal_and_viz.py:33); the viewer page differs only in
    the package named in its title."""
    from monocularsfm_torch.reconstruction.map_state import Map as TMap
    from monocularsfm_torch.viz import AsyncVisualization as TViz
    from monocularsfm_tpu.reconstruction.map_state import Map as JMap
    from monocularsfm_tpu.viz import AsyncVisualization as JViz

    s = camera_ring_scene(num_cameras=3, num_points=60, seed=4)
    for name, Map, Viz in (("jax", JMap, JViz), ("torch", TMap, TViz)):
        m = Map(s.K)
        for i in range(2):
            m.load_image(i, f"im{i}", s.observations[i][:50])
            m.add_image_pose(i, s.R[i], s.t[i])
        for k in range(30):
            m.add_point3d(s.points[k], [(0, k), (1, k)])
        viz = Viz(tmp_path / name).start()
        viz.update(m)
        viz.close()
        assert not viz._thread.is_alive()
    for f in ("live.ply", "state.json"):
        assert (tmp_path / "torch" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()
    html = (tmp_path / "torch" / "viewer.html").read_text()
    assert html == (tmp_path / "jax" / "viewer.html").read_text().replace(
        "monocularsfm_tpu", "monocularsfm_torch")
