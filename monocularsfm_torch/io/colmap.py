"""COLMAP text model writer/reader (cameras.txt, images.txt, points3D.txt).

The port of monocularsfm_tpu/io/colmap.py; the quaternion conversions run
in float32 on the CPU, as the reference's do.  A model of a few hundred
views holds millions of keypoints, so their lines are written and parsed
by `native/colmap_text.cpp`, and the points' errors are computed for all
points at once.  The numbers read back as the reference's do: each float
is written in the shortest form that reads back to the same double (`5`
where the reference's repr() writes `5.0`), and ERROR, a mean summed in
another order, may differ in its last digits.

Reference parity: Map::WriteCOLMAP (src/Reconstruction/Map.cpp:1322-1446)
emits the same three files so downstream COLMAP-compatible tooling (and the
reference's own result format) interoperates.  Unlike the reference we also
implement the reader, which turns the export into a real checkpoint.

Format (standard COLMAP sparse text model):
  cameras.txt : CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]
  images.txt  : IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME
                POINTS2D[] as (X, Y, POINT3D_ID)
  points3D.txt: POINT3D_ID X Y Z R G B ERROR TRACK[] as (IMAGE_ID, POINT2D_IDX)
"""

from __future__ import annotations

import ctypes
import pathlib

import numpy as np
import torch

from monocularsfm_torch.geometry.rotations import (
    matrix_to_quaternion,
    quaternion_to_matrix,
)


# Bytes at most of a keypoint's `X Y POINT3D_ID`, of a point's line less
# its track, and of a pair of its track (native/colmap_text.cpp).
_POINT2D_BYTES, _POINT3D_BYTES, _TRACK_PAIR_BYTES = 72, 192, 42


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32))


def _points2d_line(uv: np.ndarray, point3D: np.ndarray) -> bytes:
    """`X Y POINT3D_ID` of every keypoint, joined by spaces: each coordinate
    in its shortest round-trip form, each id or -1."""
    from monocularsfm_torch import native

    uv = np.ascontiguousarray(uv, np.float64)
    ids = np.ascontiguousarray(point3D, np.int64)
    buf = ctypes.create_string_buffer(_POINT2D_BYTES * len(uv) + 1)
    n = native.get_text_lib().colmap_points2d_line(uv, ids, len(uv), buf)
    return buf.raw[:n]


def _points3d_lines(map_obj) -> bytes:
    """The lines of points3D.txt, `POINT3D_ID X Y Z R G B ERROR TRACK[]`:
    the floats in their shortest round-trip form, the colour as RGB
    integers, ERROR the point's mean reprojection error over its track."""
    from monocularsfm_torch import native

    pts = map_obj.points_table()
    # Stored colors are BGR (OpenCV sampling); COLMAP wants RGB.
    rgb = np.ascontiguousarray(pts["bgr"][:, ::-1].astype(np.int64))
    offsets = np.concatenate([[0], np.cumsum(pts["lens"])])
    buf = ctypes.create_string_buffer(
        _POINT3D_BYTES * len(pts["ids"]) + _TRACK_PAIR_BYTES * len(pts["track"]) + 1)
    n = native.get_text_lib().colmap_points3d_lines(
        pts["ids"], pts["xyz"], rgb, pts["error"], offsets, pts["track"],
        len(pts["ids"]), buf)
    return buf.raw[:n]


def _numbers(text: bytes) -> tuple[np.ndarray, np.ndarray]:
    """The numbers of each data line of `text` (blank and '#' lines
    skipped), as float() reads them: (all of them, each line's count)."""
    from monocularsfm_torch import native

    out = np.empty(len(text) // 2 + 1)
    counts = np.empty(text.count(b"\n") + 1, np.int64)
    lines = ctypes.c_int64(0)
    n = native.get_text_lib().colmap_parse_numbers(
        text, len(text), out, len(out), counts, len(counts), ctypes.byref(lines))
    if n < 0:
        raise ValueError(f"not a number at byte {-1 - n}: "
                         f"{text[-1 - n:-1 - n + 40]!r}")
    return out[:n], counts[:lines.value]


def write_colmap(map_obj, out_dir, width: int = 0, height: int = 0):
    """Write the sparse model of a reconstruction Map to `out_dir`."""
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    K = map_obj.K

    with open(out / "cameras.txt", "w") as f:
        f.write("# Camera list with one line of data per camera:\n")
        f.write("#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        f.write(
            f"1 PINHOLE {width} {height} "
            f"{K[0,0]} {K[1,1]} {K[0,2]} {K[1,2]}\n"
        )

    ids = sorted(map_obj.registered_ids)
    quats = matrix_to_quaternion(
        _f32([map_obj.images[i].R for i in ids]).reshape(-1, 3, 3)).numpy()
    with open(out / "images.txt", "wb") as f:
        f.write(b"# Image list with two lines of data per image:\n")
        f.write(b"#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        f.write(b"#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for image_id, q in zip(ids, quats):
            im = map_obj.images[image_id]
            t = im.t
            f.write(
                f"{image_id} {q[0]} {q[1]} {q[2]} {q[3]} "
                f"{t[0]} {t[1]} {t[2]} 1 {im.name}\n".encode()
            )
            f.write(_points2d_line(im.uv, im.point3D) + b"\n")

    with open(out / "points3D.txt", "wb") as f:
        f.write(b"# 3D point list with one line of data per point:\n")
        f.write(
            b"#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
            b"TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
        )
        f.write(_points3d_lines(map_obj))


def read_colmap(model_dir):
    """Read a COLMAP text model.

    Returns dict with:
      camera: dict(model, width, height, params)
      images: {image_id: dict(q (4,), R (3,3), t (3,), name, uv (N,2),
               point3D (N,))}
      points: {pid: dict(xyz (3,), rgb (3,), error, track [(img, kpt)])}
    """
    model_dir = pathlib.Path(model_dir)

    cameras = {}
    for line in _data_lines(model_dir / "cameras.txt"):
        parts = line.split()
        cameras[int(parts[0])] = {
            "model": parts[1],
            "width": int(parts[2]),
            "height": int(parts[3]),
            "params": np.array([float(x) for x in parts[4:]]),
        }

    pts = read_colmap_points(model_dir)
    errors, ints = pts["error"].tolist(), pts["track"].ravel().tolist()
    lens, ends = pts["lens"].tolist(), np.cumsum(2 * pts["lens"]).tolist()
    points = {}
    for k, (pid, n, end) in enumerate(zip(pts["ids"].tolist(), lens, ends)):
        track = ints[end - 2 * n:end]
        points[pid] = {
            "xyz": pts["xyz"][k],
            "rgb": pts["rgb"][k],
            "error": errors[k],
            "track": list(zip(track[0::2], track[1::2])),
        }
    return {"cameras": cameras, "images": read_colmap_images(model_dir),
            "points": points}


def read_colmap_images(model_dir) -> dict:
    """The `images` of `read_colmap`: {image_id: dict(q, R, t, camera_id,
    name, uv, point3D)}."""
    images = {}
    lines = [ln for ln in (pathlib.Path(model_dir) / "images.txt").read_bytes()
             .splitlines() if ln.strip() and not ln.lstrip().startswith(b"#")]
    for i in range(0, len(lines), 2):
        parts = lines[i].decode().split()
        image_id = int(parts[0])
        q = np.array([float(x) for x in parts[1:5]])
        t = np.array([float(x) for x in parts[5:8]])
        obs = _numbers(lines[i + 1])[0].reshape(-1, 3)
        images[image_id] = {
            "q": q,
            "R": quaternion_to_matrix(_f32(q)).numpy(),
            "t": t,
            "camera_id": int(parts[8]),
            "name": parts[9],
            "uv": obs[:, :2].copy(),
            "point3D": obs[:, 2].astype(np.int64),
        }
    return images


def read_colmap_points(model_dir) -> dict:
    """The points of a COLMAP text model as arrays, in the file's order:
    ids (P,), xyz (P, 3), rgb (P, 3) uint8, error (P,), lens (P,) the
    track lengths, and track (sum of lens, 2) the (image id, keypoint)
    pairs of every track, one after the other."""
    flat, counts = _numbers((pathlib.Path(model_dir) / "points3D.txt").read_bytes())
    if np.any(counts < 8) or np.any(counts % 2):
        raise ValueError("a points3D.txt line is not ID X Y Z R G B ERROR "
                         "and (IMAGE_ID, POINT2D_IDX) pairs")
    starts = np.cumsum(counts) - counts
    head = starts[:, None] + np.arange(8)
    in_track = np.ones(len(flat), bool)
    in_track[head.ravel()] = False
    return {"ids": flat[starts].astype(np.int64),
            "xyz": flat[head[:, 1:4]],
            "rgb": flat[head[:, 4:7]].astype(np.uint8),
            "error": flat[starts + 7],
            "lens": (counts - 8) // 2,
            "track": flat[in_track].astype(np.int64).reshape(-1, 2)}


def map_from_colmap(model_dir):
    """Restore a reconstruction Map from a COLMAP text model (camera 1's
    pinhole K; keypoints in the model are already undistorted): poses,
    points and their track back-pointers, colours back to BGR."""
    from monocularsfm_torch.reconstruction.map_state import Map

    model = read_colmap(model_dir)
    fx, fy, cx, cy = model["cameras"][1]["params"][:4]
    m = Map(np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]]))
    for image_id, im in model["images"].items():
        m.load_image(image_id, im["name"], im["uv"])
        m.add_image_pose(image_id, im["R"], im["t"])
    for pid, pt in sorted(model["points"].items()):
        new_pid = m.add_point3d(pt["xyz"], pt["track"])
        m.set_color(new_pid, pt["rgb"][::-1])  # back to the BGR of the Map
    m.modified_point3D_ids.clear()
    return m


def _data_lines(path):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line
