"""A build resumed from a mid-run COLMAP snapshot and finished past the
dense-to-PCG switch, on a collection with person-hall's camera and full
OpenCV lens (the benchmark's generator, `sfmbench/lib/collection.py`), at
a small size on the CPU: 24 views of 5616x3744 on the loop, about 500
points, the snapshot at 18 registrations and `dense_max_images` 8.

The resumed build registers every view and ends on a PCG global BA; its
model is near its bundle's optimum under the plain float64 lens
(`bundle_gain` under 0.05, where this build reads 6.4e-4); the
MapBuilder's `resume`, `ba_assemble` and `ba_update` phases appear in a
profile once a resume and once a bundle, and a traced build gives the same
bits as an untraced one; the control (k2 = p1 = p2 = 0, the lens's other
terms dropped) reads a gain above 1 (1.58, with 19 views registered).
"""

import json
import os
import pathlib
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

REPO = pathlib.Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from monocularsfm_torch.config import SfMConfig  # noqa: E402
from monocularsfm_torch.database import Database  # noqa: E402
from monocularsfm_torch.io import colmap  # noqa: E402
from monocularsfm_torch.reconstruction import MapBuilder  # noqa: E402
from sfmbench.lib import collection  # noqa: E402
from sfmbench.reference import geometry, opencv_lens  # noqa: E402

VIEWS, KEYPOINTS, SNAPSHOT, DENSE_MAX = 24, 400, 18, 8
GAIN_LIMIT = 0.05
CONFIG = json.loads((REPO / "sfmbench/configs/person-hall.json").read_text())
LENS = CONFIG["settings"]["camera"]
CAM = dict(LENS, width=CONFIG["width"], height=CONFIG["height"])
SCENE = CONFIG["scene"]
OBSERVATIONS = 85


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The collection in SQLite and its snapshot at SNAPSHOT views."""
    work = tmp_path_factory.mktemp("resume_at_scale")
    coll = collection.make(SCENE, CAM, VIEWS, KEYPOINTS, 3, OBSERVATIONS)
    ids = collection.write_database(coll, str(work / "collection.db"))
    collection.write_snapshots(coll, collection.perturbed(coll, SCENE), ids,
                               {SNAPSHOT: work / "snapshot"},
                               SCENE["snapshot_min_angle_deg"])
    return work


def _set_up(job, lens: dict):
    """A MapBuilder set up as `cli.cmd_reconstruct` reads the database;
    returns (builder, keypoints)."""
    cfg = SfMConfig(database_path=str(job / "collection.db"),
                    output_path=str(job / "out"))
    for k, v in lens.items():
        setattr(cfg.camera, k, v)
    cfg.bundle.dense_max_images = DENSE_MAX
    db = Database(cfg.database_path)
    try:
        names = db.read_all_images()
        keypoints = {i: db.read_keypoints(i) for i in names}
        colors = {i: db.read_keypoints_color(i) for i in names}
        matches = {p: m for p, m in db.read_all_matches().items() if len(m)}
    finally:
        db.close()
    b = MapBuilder(cfg, device="cpu")
    b._log = lambda *a: None
    b.setup(matches, keypoints, colors=colors, names=names)
    return b, keypoints


def _build(job, lens: dict):
    """A resumed build; returns (builder, the global BAs' (cameras,
    route), keypoints)."""
    b, keypoints = _set_up(job, lens)
    events = job / "events.jsonl"
    events.unlink(missing_ok=True)
    b.enable_metrics(events)
    try:
        b.resume_from(job / "snapshot")
        b.do_build()
    finally:
        b.close()
    routes = [(e["cams"], e["solver"]) for e in
              map(json.loads, events.read_text().splitlines())
              if e["event"] == "global_ba"]
    return b, routes, keypoints


def _gain(b, keypoints) -> float:
    """bundle_gain of the builder's model against the plain float64 lens."""
    m = b.map
    reg = sorted(m.registered_ids)
    row = {i: r for r, i in enumerate(reg)}
    pids = m.point_ids()
    cam, pt, kp = [], [], []
    for j, p in enumerate(pids):
        for i, k in m.track(int(p)):
            cam.append(row[i])
            pt.append(j)
            kp.append(keypoints[i][k, :2])
    uv = opencv_lens.undistort_pixels(np.asarray(kp, np.float64), CAM)
    K = np.array([CAM["fx"], CAM["fy"], CAM["cx"], CAM["cy"]])
    g = geometry.bundle_gain(
        K, torch.as_tensor(np.stack([m.images[i].R for i in reg])),
        torch.as_tensor(np.stack([m.images[i].t for i in reg])),
        torch.as_tensor(np.stack([m.xyz(int(p)) for p in pids])),
        torch.as_tensor(cam), torch.as_tensor(pt), uv)
    return g["point_gain"] + g["camera_gain"]


def _state(b):
    m = b.map
    return ([(i, m.images[i].R.tobytes(), m.images[i].t.tobytes())
             for i in sorted(m.registered_ids)],
            [(int(p), m.xyz(int(p)).tobytes(), tuple(m.track(int(p))))
             for p in m.point_ids()])


@pytest.fixture(scope="module")
def sound(job):
    return _build(job, LENS)


def test_resumed_build_registers_every_view_and_ends_on_pcg(sound):
    b, routes, keypoints = sound
    assert b.timers["resume"].elapsed > 0
    assert len(b.map.registered_ids) == VIEWS
    assert routes and routes[-1] == (VIEWS, "pcg")
    assert all(cams > DENSE_MAX and route == "pcg" for cams, route in routes)
    assert _gain(b, keypoints) < GAIN_LIMIT


def test_phases_are_spans_and_tracing_changes_no_bit(job, sound):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = _build(job, LENS)
    names = [ev.name() for ev in prof.profiler.kineto_results.events()
             if ev.device_type() == torch.autograd.DeviceType.CPU
             and ev.is_user_annotation()]
    count = {n: names.count(n) for n in set(names)}
    bundles = (count["map_builder.local_ba"] + count["map_builder.global_ba"])
    assert count["map_builder.resume"] == 1
    assert count["map_builder.global_ba"] == len(sound[1])
    assert count["map_builder.ba_assemble"] == bundles
    assert count["map_builder.ba_update"] == bundles
    assert _state(traced[0]) == _state(sound[0])
    assert traced[1] == sound[1]


def _map_state(m):
    n = m._next_id
    return (m._xyz[:n].tobytes(), m._rgb[:n].tobytes(), m._alive.tobytes(),
            m._tracks, m.num_points3D, n, m._node_p3d.tobytes(),
            {i: im.point3D.tobytes() for i, im in m.images.items()})


def _arrays(points: dict) -> dict:
    """`points` in `io.colmap.read_colmap_points`' form, in reverse id
    order (a snapshot need not be sorted)."""
    pids = sorted(points, reverse=True)
    return {"ids": np.array(pids, np.int64),
            "xyz": np.array([points[p]["xyz"] for p in pids]),
            "rgb": np.array([points[p]["rgb"] for p in pids], np.uint8),
            "error": np.array([points[p]["error"] for p in pids]),
            "lens": np.array([len(points[p]["track"]) for p in pids]),
            "track": np.array([e for p in pids for e in points[p]["track"]],
                              np.int64).reshape(-1, 2)}


@pytest.mark.parametrize("planted", ["as written", "a keypoint in two tracks",
                                     "an image not loaded"])
def test_restore_leaves_the_state_of_one_add_point3d_a_point(job, planted):
    """`resume_from` restores the points at once; the map it leaves is, bit
    for bit, the one the per-point loop through `Map.add_point3d` leaves,
    where a keypoint lies in two tracks too (the loop then decides)."""
    model = colmap.read_colmap(job / "snapshot")
    points = dict(model["points"])
    first, second = sorted(points)[:2]
    if planted == "a keypoint in two tracks":
        points[second] = dict(points[second], track=points[second]["track"]
                              + [points[first]["track"][0]])
    elif planted == "an image not loaded":
        points[first] = dict(points[first], track=points[first]["track"][:1]
                             + [(10 ** 6, 0)])
    restored, _ = _set_up(job, LENS)
    with mock.patch.object(colmap, "read_colmap_points",
                           lambda _: _arrays(points)):
        restored.resume_from(job / "snapshot")
    loop, _ = _set_up(job, LENS)
    for image_id, im in model["images"].items():
        loop.map.add_image_pose(image_id, im["R"], im["t"])
    for pid, pt in sorted(points.items()):
        track = [(i, k) for i, k in pt["track"]
                 if i in loop.map.images and loop.map.images[i].point3D[k] < 0]
        if len(track) >= 2:
            loop.map.add_point3d(pt["xyz"], track)
    loop.map.modified_point3D_ids.clear()
    assert restored.map.num_points3D > 300
    assert _map_state(restored.map) == _map_state(loop.map)


def test_points_read_as_arrays_are_the_dict_of_read_colmap(job):
    model = colmap.read_colmap(job / "snapshot")
    pts = colmap.read_colmap_points(job / "snapshot")
    np.testing.assert_array_equal(
        pts["ids"], np.array(sorted(model["points"]), np.int64))
    ref = _arrays(model["points"])
    order = np.argsort(ref["ids"])
    starts = np.concatenate([[0], np.cumsum(ref["lens"])])
    for key in ("xyz", "rgb", "error", "lens"):
        np.testing.assert_array_equal(pts[key], ref[key][order])
    np.testing.assert_array_equal(pts["track"], np.concatenate(
        [ref["track"][starts[k]:starts[k + 1]] for k in order]))


def test_a_point_id_twice_is_refused(job):
    pts = colmap.read_colmap_points(job / "snapshot")
    pts["ids"][1] = pts["ids"][0]
    b, _ = _set_up(job, LENS)
    with mock.patch.object(colmap, "read_colmap_points", lambda _: pts):
        with pytest.raises(ValueError, match="twice"):
            b.resume_from(job / "snapshot")


def test_control_without_the_lens_other_terms_is_wrong(job):
    b, _, keypoints = _build(job, dict(LENS, k2=0.0, p1=0.0, p2=0.0))
    assert _gain(b, keypoints) > 1.0


def test_new_modules_import_no_jax():
    """In a process of its own: the generator, the stage, the plain lens,
    the new readers, the MapBuilder and the COLMAP text library load
    nothing of the JAX stack."""
    code = (
        "import sys, runpy\n"
        "import sfmbench.lib.collection, sfmbench.stages.extend\n"
        "import sfmbench.reference.opencv_lens\n"
        "import monocularsfm_torch.reconstruction.map_builder\n"
        "import monocularsfm_torch.native\n"
        "monocularsfm_torch.native.get_text_lib()\n"
        "for name in ('map_builder.resume_ms', "
        "'map_builder.ba_assemble_ms_per_build', "
        "'map_builder.register_ms_per_appended_image', "
        "'map_builder.local_ba_ms_per_build'):\n"
        "    runpy.run_path(f'sfmbench/metrics/{name}.py')\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'monocularsfm_tpu')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
