"""COLMAP text model writer/reader (cameras.txt, images.txt, points3D.txt).

The port of monocularsfm_tpu/io/colmap.py; the quaternion conversions run
in float32 on the CPU, as the reference's do.

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

import pathlib

import numpy as np
import torch

from monocularsfm_torch.geometry.rotations import (
    matrix_to_quaternion,
    quaternion_to_matrix,
)


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32))


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

    with open(out / "images.txt", "w") as f:
        f.write("# Image list with two lines of data per image:\n")
        f.write("#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        f.write("#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for image_id in sorted(map_obj.registered_ids):
            im = map_obj.images[image_id]
            q = matrix_to_quaternion(_f32(im.R)).numpy()
            t = im.t
            f.write(
                f"{image_id} {q[0]} {q[1]} {q[2]} {q[3]} "
                f"{t[0]} {t[1]} {t[2]} 1 {im.name}\n"
            )
            parts = []
            for k in range(len(im.uv)):
                pid = int(im.point3D[k])
                parts.append(
                    f"{im.uv[k,0]} {im.uv[k,1]} {pid if pid >= 0 else -1}"
                )
            f.write(" ".join(parts) + "\n")

    with open(out / "points3D.txt", "w") as f:
        f.write("# 3D point list with one line of data per point:\n")
        f.write(
            "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
            "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
        )
        for pid in map_obj.point_ids():
            pid = int(pid)
            X = map_obj.xyz(pid)
            bgr = map_obj.color(pid)
            err = float(map_obj.reproj_errors_of_track(pid).mean())
            track = " ".join(
                f"{img} {kpt}" for img, kpt in map_obj.track(pid)
            )
            # Stored colors are BGR (OpenCV sampling); COLMAP wants RGB.
            f.write(
                f"{pid} {X[0]} {X[1]} {X[2]} "
                f"{int(bgr[2])} {int(bgr[1])} {int(bgr[0])} {err} {track}\n"
            )


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

    images = {}
    lines = list(_data_lines(model_dir / "images.txt"))
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        image_id = int(parts[0])
        q = np.array([float(x) for x in parts[1:5]])
        t = np.array([float(x) for x in parts[5:8]])
        name = parts[9]
        obs = lines[i + 1].split()
        uv = []
        p3d = []
        for j in range(0, len(obs), 3):
            uv.append((float(obs[j]), float(obs[j + 1])))
            p3d.append(int(obs[j + 2]))
        images[image_id] = {
            "q": q,
            "R": quaternion_to_matrix(_f32(q)).numpy(),
            "t": t,
            "camera_id": int(parts[8]),
            "name": name,
            "uv": np.array(uv) if uv else np.zeros((0, 2)),
            "point3D": np.array(p3d, np.int64) if p3d else np.zeros(0, np.int64),
        }

    points = {}
    for line in _data_lines(model_dir / "points3D.txt"):
        parts = line.split()
        pid = int(parts[0])
        track = [
            (int(parts[j]), int(parts[j + 1])) for j in range(8, len(parts), 2)
        ]
        points[pid] = {
            "xyz": np.array([float(x) for x in parts[1:4]]),
            "rgb": np.array([int(x) for x in parts[4:7]], np.uint8),
            "error": float(parts[7]),
            "track": track,
        }
    return {"cameras": cameras, "images": images, "points": points}


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
        m._rgb[new_pid] = pt["rgb"][::-1]  # back to the BGR of the Map
    m.modified_point3D_ids.clear()
    return m


def _data_lines(path):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line
