"""The port's distorted-camera path against the JAX package's, on the CPU:
the undistortion maps, the OpenCV-free image remap of the OpenMVS export,
and a reconstruction from distorted keypoints."""

import numpy as np
import pytest

from monocularsfm_torch.io import openmvs as TO
from monocularsfm_torch.utils.synthetic import (
    camera_ring_scene,
    render_textured_images,
    similarity_align,
)
from monocularsfm_tpu.io import openmvs as JO
from test_map_builder import scene_to_matches

DIST = np.array([-0.08, 0.012, 4e-4, -6e-4])   # tests/test_distortion_pipeline.py
POSE_TOL = 0.01                                # tests/test_torch_map_builder.py
# cv2.remap (OpenCV 5) blends in float32 too, in another order: a pixel may
# round to the neighbouring level.
GREY_TOL, GREY_SHARE = 1, 1e-3


def _image(rng, w=320, h=240):
    imgs, K, _, _ = render_textured_images(num_cameras=1, width=w, height=h,
                                           scene_seed=3)
    noise = rng.integers(0, 60, (h, w, 3))
    bgr = np.clip(imgs[0][..., None].astype(int) + noise, 0, 255).astype(np.uint8)
    return bgr, np.asarray(K, float)


@pytest.mark.parametrize("dist", [DIST, [0.3, -0.2, 0.01, 0.02], [0.0] * 4])
def test_undistort_maps_equal_reference(dist):
    K = np.array([[500.0, 0, 330.5], [0, 505.0, 241.0], [0, 0, 1]])
    for a, b in zip(TO._undistort_maps(K, dist, 64, 48),
                    JO._undistort_maps(K, dist, 64, 48)):
        np.testing.assert_array_equal(a, b)


def test_remap_within_one_grey_level_of_opencv():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    bgr, K = _image(rng)
    cases = [TO._undistort_maps(K, d, 320, 240)
             for d in (DIST, [0.3, -0.2, 0.01, 0.02], [-0.5, 0.1, 0.0, 0.0])]
    # Positions off the image on every side: zero outside, as BORDER_CONSTANT.
    cases.append(tuple(rng.uniform(-5, hi + 5, (50, 60)).astype(np.float32)
                       for hi in (320, 240)))
    for img in (bgr, np.ascontiguousarray(bgr[..., 1])):
        for mx, my in cases:
            ref = cv2.remap(img, mx, my, cv2.INTER_LINEAR)
            d = np.abs(TO._remap_linear(img, mx, my).astype(int) - ref.astype(int))
            assert d.max() <= GREY_TOL and (d > 0).mean() <= GREY_SHARE


def test_openmvs_dump_matches_reference(tmp_path):
    """write_openmvs with nonzero distortion: the same archive and image
    names, and undistorted images within 1 grey level of the JAX package's
    (which remaps with cv2)."""
    pytest.importorskip("cv2")
    from monocularsfm_torch.reconstruction.map_state import Map as TMap
    from monocularsfm_torch.utils.png import read_png, write_png
    from monocularsfm_tpu.reconstruction.map_state import Map as JMap

    rng = np.random.default_rng(1)
    images = tmp_path / "images"
    images.mkdir()
    s = camera_ring_scene(num_cameras=3, num_points=40, seed=2)
    for i in range(3):
        write_png(images / f"v{i}.png", _image(rng)[0][..., ::-1])
    out = {}
    for name, Map, mod in (("jax", JMap, JO), ("torch", TMap, TO)):
        m = Map(s.K, DIST)
        for i in range(3):
            m.load_image(i, f"v{i}.png", s.observations[i][:40])
        for i in range(2):
            m.add_image_pose(i, s.R[i], s.t[i])
        for k in range(20):
            m.add_point3d(s.points[k], [(0, k), (1, k)])
        d = tmp_path / name
        d.mkdir()
        mod.write_openmvs(m, d / "scene.mvs", images_path=str(images), dist=DIST)
        out[name] = d
    assert ((out["torch"] / "scene.mvs").read_bytes()
            == (out["jax"] / "scene.mvs").read_bytes())
    summary = TO.read_openmvs_summary(out["torch"] / "scene.mvs")
    assert summary["images"] == 3 and summary["posed_images"] == 2
    assert summary["image_names"] == [f"undistorted_images/v{i}.png" for i in range(3)]
    for i in range(3):
        a = read_png(out["torch"] / "undistorted_images" / f"v{i}.png").astype(int)
        b = read_png(out["jax"] / "undistorted_images" / f"v{i}.png").astype(int)
        src = read_png(images / f"v{i}.png").astype(int)
        assert np.abs(a - b).max() <= GREY_TOL and (a != b).mean() <= GREY_SHARE
        assert np.abs(a - src).mean() > 1.0          # really remapped


def _distorted(keypoints, K):
    import torch

    from monocularsfm_torch.ops.undistort import distort

    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    out = {}
    for i, uv in keypoints.items():
        xn = np.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], -1)
        xd = distort(torch.from_numpy(xn.astype(np.float32)),
                     torch.from_numpy(DIST.astype(np.float32))).numpy()
        out[i] = np.stack([xd[:, 0] * fx + cx, xd[:, 1] * fy + cy], -1).astype(np.float32)
    return out


def test_distorted_reconstruction_matches_reference():
    """A distorted ring (as tests/test_distortion_pipeline.py, at the size of
    tests/test_torch_map_builder.py): the Map undistorts the keypoints once,
    and both packages register every view on the same trajectory."""
    from monocularsfm_torch import config as tc
    from monocularsfm_torch.reconstruction import MapBuilder as TB
    from monocularsfm_tpu import config as jc
    from monocularsfm_tpu.reconstruction import MapBuilder as JB

    scene = camera_ring_scene(num_cameras=6, num_points=300, seed=17, arc_deg=100.0)
    keypoints, matches = scene_to_matches(scene, noise_px=0.2, outlier_frac=0.03)
    keypoints = _distorted(keypoints, scene.K)
    maps = {}
    for name, B, mod in (("jax", JB, jc), ("torch", TB, tc)):
        cfg = mod.SfMConfig()
        cfg.camera.fx, cfg.camera.fy = scene.K[0, 0], scene.K[1, 1]
        cfg.camera.cx, cfg.camera.cy = scene.K[0, 2], scene.K[1, 2]
        cfg.camera.k1, cfg.camera.k2, cfg.camera.p1, cfg.camera.p2 = DIST
        b = B(cfg, **({"device": "cpu"} if name == "torch" else {}))
        b._log = lambda *a: None
        b.setup(matches, keypoints)
        summary = b.do_build()
        assert summary.num_registered == 6 and summary.mean_reprojection_error < 0.8
        maps[name] = b.map
    ids = sorted(maps["torch"].registered_ids)
    assert ids == sorted(maps["jax"].registered_ids)
    centres = {n: np.array([-m.images[i].R.T @ m.images[i].t for i in ids])
               for n, m in maps.items()}
    gt = np.array([-scene.R[i].T @ scene.t[i] for i in ids])
    scale = np.linalg.norm(gt - gt.mean(0), axis=1).mean()
    for n in maps:
        _, rms = similarity_align(centres[n], gt)
        assert rms / scale < POSE_TOL, n
    _, rms = similarity_align(centres["torch"], centres["jax"])
    assert rms / scale < POSE_TOL
