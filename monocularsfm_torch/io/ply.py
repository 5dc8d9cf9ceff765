"""PLY point-cloud writers (ascii + binary little-endian).

Reference parity: Map::WritePLY / WritePLYBinary
(src/Reconstruction/Map.cpp:1608-1675) — xyz + rgb vertices.
"""

from __future__ import annotations

import struct

import numpy as np


def _gather(map_obj):
    pids = map_obj.point_ids()
    xyz = np.array([map_obj.xyz(int(p)) for p in pids]) if len(pids) else np.zeros((0, 3))
    bgr = np.array([map_obj.color(int(p)) for p in pids]) if len(pids) else np.zeros((0, 3))
    rgb = bgr[:, ::-1].astype(np.uint8) if len(bgr) else bgr.astype(np.uint8)
    return xyz, rgb


def _header(n, binary):
    fmt = "binary_little_endian 1.0" if binary else "ascii 1.0"
    return (
        f"ply\nformat {fmt}\nelement vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )


def write_ply(map_obj, path):
    xyz, rgb = _gather(map_obj)
    with open(path, "w") as f:
        f.write(_header(len(xyz), binary=False))
        for p, c in zip(xyz, rgb):
            f.write(f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")


def write_ply_binary(map_obj, path):
    xyz, rgb = _gather(map_obj)
    with open(path, "wb") as f:
        f.write(_header(len(xyz), binary=True).encode("ascii"))
        for p, c in zip(xyz.astype(np.float32), rgb):
            f.write(struct.pack("<fffBBB", p[0], p[1], p[2], c[0], c[1], c[2]))


def read_ply(path):
    """Minimal reader for both our formats (round-trip tests)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        n = next(int(h.split()[-1]) for h in header if h.startswith("element vertex"))
        binary = any("binary_little_endian" in h for h in header)
        xyz = np.zeros((n, 3), np.float32)
        rgb = np.zeros((n, 3), np.uint8)
        if binary:
            for i in range(n):
                vals = struct.unpack("<fffBBB", f.read(15))
                xyz[i] = vals[:3]
                rgb[i] = vals[3:]
        else:
            for i in range(n):
                parts = f.readline().split()
                xyz[i] = [float(x) for x in parts[:3]]
                rgb[i] = [int(x) for x in parts[3:6]]
    return xyz, rgb
