"""The port's Map and PLY writers against the JAX package's, on one seeded
map built in both: a 6-view ring whose images hold clutter keypoints beside
the observations, one pose moved off the truth, points split in two, cut
short and planted off their place, so that filtering, completion, merging,
the BA bridge and the statistics all have work.  Every public output and
the point state (ids, xyz, colours, tracks) must be equal, bit for bit."""

import dataclasses

import numpy as np
import pytest

from monocularsfm_torch.io import ply as tply
from monocularsfm_torch.reconstruction import Map as TMap, SceneGraph as TGraph
from monocularsfm_torch.utils.synthetic import camera_ring_scene

VIEWS, POINTS, CLUTTER = 6, 300, 120


def _map(pkg: str):
    """The seeded map in package `pkg` ("torch" or "jax")."""
    if pkg == "torch":
        Map, SceneGraph = TMap, TGraph
    else:
        from monocularsfm_tpu.reconstruction import Map, SceneGraph
    scene = camera_ring_scene(num_cameras=VIEWS, num_points=POINTS, seed=5,
                              noise_px=0.4)
    rng = np.random.default_rng(5)
    keypoints, colors = {}, {}
    for c in range(VIEWS):
        clutter = rng.uniform(0, [scene.width, scene.height], (CLUTTER, 2))
        keypoints[c] = np.concatenate([scene.observations[c], clutter])
        colors[c] = rng.integers(0, 256, (len(keypoints[c]), 3), dtype=np.uint8)
    matches = {}
    for i in range(VIEWS):
        for j in range(i + 1, VIEWS):
            common = np.nonzero(scene.visible[i] & scene.visible[j])[0]
            wrong = rng.integers(POINTS, POINTS + CLUTTER, (5, 2))
            matches[(i, j)] = np.concatenate(
                [np.stack([common, common], 1), wrong]).astype(np.int32)
    g = SceneGraph().load(matches, {c: len(k) for c, k in keypoints.items()})
    m = Map(scene.K)
    for c in range(VIEWS):
        m.load_image(c, f"view{c}.png", keypoints[c], colors[c])
    m.attach_scene_graph(g)
    for c in range(VIEWS):
        m.add_image_pose(c, scene.R[c], scene.t[c] + (0.02 if c == 3 else 0.0))
    for p in range(POINTS):
        cams = [c for c in range(VIEWS) if scene.visible[c, p]]
        X = scene.points[p] + 0.002
        if p % 5 == 0 and len(cams) >= 4:         # split: work for merging
            half = len(cams) // 2
            m.add_point3d(X, [(c, p) for c in cams[:half]])
            m.add_point3d(X + 0.001, [(c, p) for c in cams[half:]])
        elif p % 5 == 1 and len(cams) >= 3:       # cut short: for completion
            m.add_point3d(X, [(c, p) for c in cams[:2]])
        elif p % 7 == 2 and len(cams) >= 2:       # planted: for filtering
            m.add_point3d(X + 0.4, [(c, p) for c in cams])
        elif len(cams) >= 2:
            m.add_point3d(X, [(c, p) for c in cams])
    return m


def _state(m):
    """A map's point state through its public accessors."""
    ids = [int(p) for p in m.point_ids()]
    return (ids, [m.xyz(p).tobytes() for p in ids],
            [np.asarray(m.color(p)).tobytes() for p in ids],
            [[(int(i), int(k)) for i, k in m.track(p)] for p in ids],
            m.num_points3D, sorted(m.modified_point3D_ids),
            {i: im.point3D.tobytes() for i, im in m.images.items()})


def _bundle(out):
    """(image ids, point ids, the problem's arrays) of a BA bridge call."""
    prob, image_ids, pids = out
    arrays = {name: np.asarray(getattr(prob, name))
              for name in prob.__dataclass_fields__
              if getattr(prob, name) is not None}
    return image_ids, [int(p) for p in pids], arrays


OPERATIONS = {
    "filter_points": lambda m: m.filter_points(
        [int(p) for p in m.point_ids()], 4.0, 1.5),
    "complete_points": lambda m: m.complete_points(
        [int(p) for p in m.point_ids()], 4.0, 5),
    "merge_points": lambda m: m.merge_points(
        [int(p) for p in m.point_ids()], 4.0),
    "get_local_ba_data": lambda m: [
        _bundle(m.get_local_ba_data(2, allow_split=split, track_width=2))
        for split in (False, True)],
    "get_global_ba_data": lambda m: [
        _bundle(m.get_global_ba_data(track_width=2, allow_split=split))
        for split in (False, True)],
    "statistics": lambda m: dataclasses.asdict(m.statistics()),
}


@pytest.mark.parametrize("op", list(OPERATIONS))
def test_map_operation_equals_reference_exactly(op):
    mt, mj = _map("torch"), _map("jax")
    assert _state(mt) == _state(mj)
    out_t, out_j = OPERATIONS[op](mt), OPERATIONS[op](mj)
    if op.startswith("get_"):
        for (ids_t, pids_t, arr_t), (ids_j, pids_j, arr_j) in zip(out_t, out_j):
            assert ids_t == ids_j and pids_t == pids_j
            assert arr_t.keys() == arr_j.keys()
            for name in arr_t:
                np.testing.assert_array_equal(arr_t[name], arr_j[name],
                                              err_msg=name)
    else:
        assert out_t == out_j
        if op != "statistics":
            assert out_t > 0
    assert _state(mt) == _state(mj)


@pytest.mark.parametrize("writer", ["write_ply", "write_ply_binary"])
def test_ply_bytes_equal_reference(tmp_path, writer):
    from monocularsfm_tpu.io import ply as jply

    getattr(tply, writer)(_map("torch"), tmp_path / "torch.ply")
    getattr(jply, writer)(_map("jax"), tmp_path / "jax.ply")
    ours = (tmp_path / "torch.ply").read_bytes()
    assert ours == (tmp_path / "jax.ply").read_bytes()
    assert f"element vertex {_map('torch').num_points3D}\n".encode() in ours


def test_points_table_is_the_accessors():
    m = _map("torch")
    m.filter_points([int(p) for p in m.point_ids()], 4.0, 1.5)
    pts = m.points_table()
    ids = [int(p) for p in m.point_ids()]
    assert pts["ids"].tolist() == ids and len(ids) > 100
    np.testing.assert_array_equal(pts["xyz"], [m.xyz(p) for p in ids])
    np.testing.assert_array_equal(pts["bgr"], [m.color(p) for p in ids])
    tracks = [m.track(p) for p in ids]
    assert pts["lens"].tolist() == [len(t) for t in tracks]
    assert pts["track"].tolist() == [list(e) for t in tracks for e in t]
    np.testing.assert_allclose(
        pts["error"], [m.reproj_errors_of_track(p).mean() for p in ids],
        rtol=1e-12, atol=1e-15)
