"""The port's mid-run snapshot and resume (the counterpart of
tests/test_checkpoint_resume.py): a reconstruction stopped after 5
registrations is restored from its COLMAP snapshot by a fresh builder and
finishes 8/8 under 1 px; the snapshot reads back through the JAX package's
reader with the same poses."""

import numpy as np
import pytest

from monocularsfm_torch.config import SfMConfig
from monocularsfm_torch.reconstruction import MapBuilder
from monocularsfm_torch.utils.synthetic import camera_ring_scene

from test_map_builder import scene_to_matches
from test_torch_scale_path import _one_cpu_thread  # noqa: F401


def test_snapshot_and_resume(tmp_path):
    scene = camera_ring_scene(num_cameras=8, num_points=300, seed=5, arc_deg=140.0)
    keypoints, matches = scene_to_matches(scene, noise_px=0.2, outlier_frac=0.02)
    snap = tmp_path / "snap"

    def make_builder():
        cfg = SfMConfig()
        cfg.camera.fx, cfg.camera.fy = scene.K[0, 0], scene.K[1, 1]
        cfg.camera.cx, cfg.camera.cy = scene.K[0, 2], scene.K[1, 2]
        cfg.map_builder.snapshot_every_registrations = 2
        cfg.map_builder.snapshot_dir = str(snap)
        b = MapBuilder(cfg, device="cpu")
        b._log = lambda *a: None
        b.setup(matches, keypoints)
        return b

    # Run 1: a crash after 5 registrations (an exception from the loop).
    b1 = make_builder()
    orig = b1.try_register

    def bomb(image_id):
        ok = orig(image_id)
        if ok and len(b1.map.registered_ids) >= 5:
            raise KeyboardInterrupt
        return ok

    b1.try_register = bomb
    with pytest.raises(KeyboardInterrupt):
        b1.do_build()
    assert (snap / "images.txt").exists()

    # The snapshot is a COLMAP model the JAX package reads with the same poses.
    from monocularsfm_torch.io.colmap import read_colmap as t_read
    from monocularsfm_tpu.io.colmap import read_colmap as j_read

    ours, ref = t_read(snap), j_read(snap)
    assert sorted(ours["images"]) == sorted(ref["images"])
    assert len(ref["images"]) >= 4
    for i, im in ref["images"].items():
        np.testing.assert_allclose(ours["images"][i]["R"], im["R"], atol=1e-6)
        np.testing.assert_array_equal(ours["images"][i]["t"], im["t"])
    assert sorted(ours["points"]) == sorted(ref["points"])

    # Run 2: a fresh builder restores the snapshot and completes.
    b2 = make_builder()
    b2.resume_from(snap)
    assert len(b2.map.registered_ids) >= 2
    b2.map.debug_check()
    summary = b2.do_build()
    assert summary.num_registered == 8
    assert summary.mean_reprojection_error < 1.0
