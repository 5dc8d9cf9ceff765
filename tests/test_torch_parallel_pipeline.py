"""The multi-device layer reached through the pipeline, on gloo worlds of 2
CPU ranks: the dry run (its MapBuilder builds on rank 0 while rank 1
serves the sharded global BAs) against the JAX package's sharded MapBuilder
on the same scene and config, and `sfm-torch reconstruct` under
`torch.distributed.run` against one process."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from monocularsfm_torch.parallel import dryrun
from test_torch_map_builder import _config, _events

REPO = pathlib.Path(__file__).resolve().parent.parent
# tests/test_torch_map_builder.py's tolerances for the unsharded build.
POINTS_REL, REPROJ_PX, TRAJ_REL = 0.05, 0.05, 0.01
WORLD_TIMEOUT = 60.0


@pytest.fixture(scope="module")
def scene_inputs():
    return dryrun.ring_scene_inputs()


@pytest.fixture(scope="module")
def dry():
    return dryrun.dryrun_multichip(2, device="cpu", timeout=WORLD_TIMEOUT)


def _trajectory_error(poses, scene):
    from monocularsfm_torch.utils.synthetic import similarity_align

    ids = sorted(poses)
    est = np.array([-poses[i][0].T @ poses[i][1] for i in ids])
    gt = np.array([-scene.R[i].T @ scene.t[i] for i in ids])
    _, rms = similarity_align(est, gt)
    return rms / np.linalg.norm(gt - gt.mean(0), axis=1).mean()


def test_dryrun_builds_on_the_sharded_path(dry, scene_inputs):
    scene = scene_inputs[0]
    gba = [e for e in dry["events"] if e["event"] == "global_ba"]
    assert dry["num_registered"] >= scene.num_cameras - 1
    assert dry["mesh"] and gba
    assert all(e["sharded"] for e in gba)
    # dense_max_images = 2: every global BA past the first pair runs PCG,
    # on whole tracks (a mesh gets no split rows).
    assert {e["solver"] for e in gba if e["cams"] > 2} == {"pcg"}
    assert dry["ring_pairs"] >= 0 and np.isfinite(dry["ba_cost_final"])
    assert _trajectory_error(dry["poses"], scene) < TRAJ_REL


def test_dryrun_agrees_with_jax_sharded_builder(dry, scene_inputs, tmp_path):
    """The JAX MapBuilder on the session's virtual devices with the same
    config (mesh_shape (2,), dense_max_images 2, 8 LM iterations): the
    same registered set, points and reprojection within the unsharded
    build's tolerances, both sharded."""
    from monocularsfm_tpu import config as jc
    from monocularsfm_tpu.reconstruction import MapBuilder

    scene, matches, keypoints = scene_inputs
    cfg = _config(jc, scene)
    cfg.parallel.shard_ba = True
    cfg.parallel.mesh_shape = (2,)
    cfg.bundle.dense_max_images = 2
    cfg.bundle.max_iterations = 8
    b = MapBuilder(cfg)
    b._log = lambda *a: None
    b.enable_metrics(tmp_path / "jax.jsonl")
    b.setup(matches, keypoints)
    s = b.do_build()
    b._metrics_fh.close()
    assert sorted(b.map.registered_ids) == dry["registered_ids"]
    assert abs(dry["num_points3D"] - s.num_points3D) <= POINTS_REL * s.num_points3D
    assert abs(dry["mean_reprojection_error"] - s.mean_reprojection_error) <= REPROJ_PX
    jax_gba = [e for e in _events(tmp_path / "jax.jsonl") if e["event"] == "global_ba"]
    assert jax_gba and all(e["sharded"] for e in jax_gba)


def _write_db(path, matches, keypoints):
    from monocularsfm_torch.database import Database

    db = Database(str(path))
    for i in sorted(keypoints):
        k = keypoints[i]
        iid = db.write_image(f"image{i}.png")
        assert iid == i + 1
        db.write_keypoints(iid, np.c_[k, np.ones((len(k), 1)), np.zeros((len(k), 1))]
                           .astype(np.float32))
    for (a, b), m in matches.items():
        db.write_matches(a + 1, b + 1, m)
    db.close()


def _cli(tmp_path, name, scene, ranks):
    """`sfm-torch reconstruct --device cpu --metrics` on the database, in
    one process or under torch.distributed.run with `ranks` ranks; returns
    the completed process, the COLMAP model it wrote and its global-BA
    events."""
    from monocularsfm_torch.io.colmap import read_colmap

    out = tmp_path / name
    cfg = tmp_path / f"{name}.yaml"
    cfg.write_text(
        f"database_path: {tmp_path / 'scene.db'}\n"
        f"output_path: {out}\n"
        f"images_path: {tmp_path / 'images'}\n"
        f"camera: {{fx: {scene.K[0, 0]}, fy: {scene.K[1, 1]}, "
        f"cx: {scene.K[0, 2]}, cy: {scene.K[1, 2]}}}\n"
        "bundle: {dense_max_images: 2, max_iterations: 8}\n")
    launch = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(ranks)] if ranks > 1 else [sys.executable])
    res = subprocess.run(
        launch + ["-m", "monocularsfm_torch.cli", "reconstruct", str(cfg),
                  "--device", "cpu", "--metrics", str(tmp_path / f"{name}.jsonl")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    events = _events(tmp_path / f"{name}.jsonl")
    return res, read_colmap(str(out / "colmap")), [
        e for e in events if e["event"] == "global_ba"]


def test_cli_reconstruct_under_two_ranks(tmp_path, scene_inputs):
    """Rank 0 reconstructs and writes the outputs; rank 1 serves the
    sharded global BAs.  The same registered count as one process."""
    scene, matches, keypoints = scene_inputs
    _write_db(tmp_path / "scene.db", matches, keypoints)
    one, model_one, gba_one = _cli(tmp_path, "one", scene, 1)
    two, model_two, gba_two = _cli(tmp_path, "two", scene, 2)
    assert len(model_two["images"]) == len(model_one["images"]) >= scene.num_cameras - 1
    assert gba_one and not any(e["sharded"] for e in gba_one)
    assert gba_two and all(e["sharded"] for e in gba_two)
    assert two.stdout.count("[export] COLMAP/PLY/OpenMVS written") == 1
    assert "backend gloo" in two.stderr
