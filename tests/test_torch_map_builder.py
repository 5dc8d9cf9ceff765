"""The whole reconstruct slice: the port's MapBuilder against the JAX
package's on the same synthetic correspondences, on the CPU.  Each package
draws its own RANSAC uniforms, as a user's run does."""

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
def builds():
    from monocularsfm_torch import config as tc
    from monocularsfm_torch.reconstruction import MapBuilder as TB
    from monocularsfm_tpu import config as jc
    from monocularsfm_tpu.reconstruction import MapBuilder as JB

    scene = camera_ring_scene(num_cameras=6, num_points=300, seed=21, arc_deg=100.0)
    keypoints, matches = scene_to_matches(scene)
    quiet = lambda *a: None  # noqa: E731
    out = {}
    for name, B, mod in (("jax", JB, jc), ("torch", TB, tc)):
        kw = {"device": "cpu"} if name == "torch" else {}
        b = B(_config(mod, scene), **kw)
        b._log = quiet
        b.setup(matches, keypoints)
        out[name] = (b, b.do_build())
    return scene, out


def test_same_registered_set(builds):
    scene, out = builds
    (bj, sj), (bt, st) = out["jax"], out["torch"]
    assert sorted(bt.map.registered_ids) == sorted(bj.map.registered_ids)
    assert st.num_registered == scene.num_cameras


def test_points_and_reprojection_agree(builds):
    _, out = builds
    sj, st = out["jax"][1], out["torch"][1]
    assert abs(st.num_points3D - sj.num_points3D) <= 0.05 * sj.num_points3D
    assert abs(st.mean_reprojection_error - sj.mean_reprojection_error) <= 0.05
    assert st.mean_reprojection_error < 1.0


def test_trajectories_within_one_percent(builds):
    scene, out = builds
    for name in ("jax", "torch"):
        err = _trajectory_error(out[name][0], scene)
        assert err < 0.01, (name, err)
