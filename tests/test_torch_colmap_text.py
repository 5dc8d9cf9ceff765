"""The port's COLMAP text writer and reader against the per-keypoint and
per-point loops they replace (kept here as the reference): the keypoint
lines from `native/colmap_text.cpp` hold the numbers of
`f"{uv[k, 0]} {uv[k, 1]} {pid}"`, every float in a form that `float()`
reads back to the same double; every line of the model but the points'
ERROR does too (the quaternions now converted in one batch), and ERROR, a
mean summed in another order, agrees to 1e-12 relative; the reader's native
parse gives the values `float()` and `int()` give."""

import math

import numpy as np
import pytest
import torch

from monocularsfm_torch.geometry.rotations import matrix_to_quaternion
from monocularsfm_torch.io import colmap
from monocularsfm_torch.reconstruction.map_state import Map
from monocularsfm_torch.utils.synthetic import camera_ring_scene

EDGE = [0.0, -0.0, 1.0, -1.0, 5.0, 0.1, 1e-4, 1e-5, 9.999e-5, 0.00012345,
        1e15, 1e16, 9999999999999998.0, 1.5e16, 123456789012345678.0,
        5e-324, 1.7976931348623157e308, 2.0 ** -30, 1 / 3, -2.5e-7,
        math.inf, -math.inf, 3649.162353515625, 1e22, 1e-300]


def _loop_header(image_id, im) -> str:
    q = matrix_to_quaternion(torch.as_tensor(np.asarray(im.R, np.float32))).numpy()
    t = im.t
    return f"{image_id} {q[0]} {q[1]} {q[2]} {q[3]} {t[0]} {t[1]} {t[2]} 1 {im.name}"


def _same_numbers(ours: str, ref: str) -> bool:
    """The same tokens, each read as a number where it is one."""
    a, b = ours.split(" "), ref.split(" ")

    def value(tok):
        try:
            return np.float64(tok).tobytes()
        except ValueError:
            return tok
    return len(a) == len(b) and all(map(lambda x, y: value(x) == value(y), a, b))


def _loop_line(uv, pids) -> str:
    parts = []
    for k in range(len(uv)):
        pid = int(pids[k])
        parts.append(f"{uv[k, 0]} {uv[k, 1]} {pid if pid >= 0 else -1}")
    return " ".join(parts)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_keypoint_line_is_the_loops(dtype):
    rng = np.random.default_rng(7)
    n = 20000
    uv = np.concatenate([
        rng.uniform(-400, 6000, (n, 2)),
        rng.normal(0, 1, (n, 2)) * 10.0 ** rng.integers(-12, 18, (n, 1)),
        np.array(EDGE).reshape(-1, 1).repeat(2, 1)])
    with np.errstate(over="ignore"):
        uv = uv.astype(dtype)
    pids = rng.integers(-3, 2 ** 40, len(uv))
    pids[:3] = [-1, 0, 2 ** 62]
    line = colmap._points2d_line(uv, pids).decode()
    assert _same_numbers(line, _loop_line(uv, pids))
    tok = line.split(" ")
    assert [int(x) for x in tok[2::3]] == np.where(pids >= 0, pids, -1).tolist()
    assert all(len(x) <= 24 for x in tok)


def test_nan_is_written_as_a_nan():
    uv = np.array([[math.nan, -math.nan]])
    tok = colmap._points2d_line(uv, np.array([4])).decode().split(" ")
    assert math.isnan(float(tok[0])) and math.isnan(float(tok[1])) and tok[2] == "4"


def test_numbers_read_as_float_reads_them():
    rng = np.random.default_rng(8)
    x = np.concatenate([rng.normal(0, 1, 5000) * 10.0 ** rng.integers(-30, 30, 5000),
                        [0.0, -0.0, 1e16, 1e-05, 5e-324, 1.7976931348623157e308]]).tolist()
    text = "# a comment\n\n  " + " ".join(map(repr, x[:3000])) + "\n" + \
        "\t".join(map(repr, x[3000:])) + "  \n# another 1 2\n"
    values, counts = colmap._numbers(text.encode())
    assert counts.tolist() == [3000, len(x) - 3000]
    assert values.tobytes() == np.array(x).tobytes()
    with pytest.raises(ValueError, match="not a number"):
        colmap._numbers(b"1 2 x3\n")


def _loop_points3d(map_obj) -> list[str]:
    out = []
    for pid in map_obj.point_ids():
        pid = int(pid)
        X = map_obj.xyz(pid)
        bgr = map_obj.color(pid)
        err = float(map_obj.reproj_errors_of_track(pid).mean())
        track = " ".join(f"{img} {kpt}" for img, kpt in map_obj.track(pid))
        out.append(f"{pid} {X[0]} {X[1]} {X[2]} "
                   f"{int(bgr[2])} {int(bgr[1])} {int(bgr[0])} {err} {track}")
    return out


@pytest.fixture(scope="module")
def scene_map():
    """A 6-view ring with clutter keypoints beside the observations, points
    of every track length, colours and a pose moved off the truth."""
    scene = camera_ring_scene(num_cameras=6, num_points=300, seed=4, noise_px=0.4)
    rng = np.random.default_rng(4)
    m = Map(scene.K)
    for c in range(6):
        clutter = rng.uniform(0, 640, (150, 2))
        kps = np.concatenate([scene.observations[c], clutter])
        cols = rng.integers(0, 256, (len(kps), 3), dtype=np.uint8)
        m.load_image(c + 1, f"view{c}.png", kps, cols)
        m.add_image_pose(c + 1, scene.R[c], scene.t[c] + 0.01 * c)
    for p in range(scene.num_points):
        track = [(c + 1, p) for c in range(6) if scene.visible[c, p]]
        if len(track) >= 2:
            m.add_point3d(scene.points[p] + 0.003, track)
    return m


def test_model_is_the_loops(scene_map, tmp_path):
    colmap.write_colmap(scene_map, tmp_path, width=640, height=480)
    images = (tmp_path / "images.txt").read_text().splitlines()
    body = [ln for ln in images if not ln.startswith("#")]
    for k, image_id in enumerate(sorted(scene_map.registered_ids)):
        im = scene_map.images[image_id]
        assert body[2 * k] == _loop_header(image_id, im)
        assert _same_numbers(body[2 * k + 1], _loop_line(im.uv, im.point3D))
    points = [ln for ln in (tmp_path / "points3D.txt").read_text().splitlines()
              if not ln.startswith("#")]
    loop = _loop_points3d(scene_map)
    assert len(points) == len(loop) > 100
    for ours, ref in zip(points, loop):
        a, b = ours.split(), ref.split()
        assert _same_numbers(" ".join(a[:7] + a[8:]), " ".join(b[:7] + b[8:]))
        assert float(a[7]) == pytest.approx(float(b[7]), rel=1e-12, abs=1e-15)


def test_reader_parses_as_the_loop(scene_map, tmp_path):
    colmap.write_colmap(scene_map, tmp_path)
    model = colmap.read_colmap(tmp_path)
    lines = [ln for ln in (tmp_path / "images.txt").read_text().splitlines()
             if not ln.startswith("#")]
    for head, obs in zip(lines[0::2], lines[1::2]):
        tok = obs.split()
        im = model["images"][int(head.split()[0])]
        uv = np.array([(float(tok[j]), float(tok[j + 1]))
                       for j in range(0, len(tok), 3)])
        ids = np.array([int(tok[j + 2]) for j in range(0, len(tok), 3)])
        np.testing.assert_array_equal(im["uv"], uv)
        assert im["uv"].dtype == np.float64
        np.testing.assert_array_equal(im["point3D"], ids)
        assert im["point3D"].dtype == np.int64
    restored = colmap.map_from_colmap(tmp_path)
    for pid in scene_map.point_ids():
        assert restored.track(int(pid)) == [
            (int(i), int(k)) for i, k in scene_map.track(int(pid))]
