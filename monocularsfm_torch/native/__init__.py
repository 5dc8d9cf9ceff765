"""Native (C++) host-runtime components, loaded via ctypes.

The port keeps its own copy of the scene-graph core,
`scene_graph_core.cpp` beside this file (byte-equal to the JAX package's
`native/scene_graph_core.cpp`; tests/test_torch_copies.py holds it so):
g++ compiles it at first use into `build/monocularsfm_torch/` at the root
of the checkout, under a name that carries a hash of the source and flags,
so an edited source is rebuilt.
The API (`get_lib()`, `available()`) is the reference's, so the copied
`reconstruction/map_state.py` runs unchanged.  A failed build or load
raises; the numpy track-maintenance path stays selectable with
`Map.attach_scene_graph(use_native=False)`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess

import numpy as np

_HERE = pathlib.Path(__file__).resolve().parent
_ROOT = _HERE.parent.parent
SRC = _HERE / "scene_graph_core.cpp"
BUILD_DIR = _ROOT / "build" / "monocularsfm_torch"
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lib = None


def library_path() -> pathlib.Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libsfm_native_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the scene-graph core unless this exact build exists."""
    if not SRC.exists():
        raise RuntimeError(f"native source {SRC} is missing")
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, str(SRC), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the native core cannot be built") from e
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}):\n{' '.join(cmd)}\n"
                           f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    return out


def get_lib():
    """The loaded native library (built on the first call)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    i64 = ctypes.c_int64
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.build_csr.argtypes = [i64, i64, p_i32, p_i32, p_i64, p_i32]
    lib.build_csr.restype = None
    lib.get_2d3d.argtypes = [
        i64, i64, p_i64, p_i32, p_i32, p_i64, p_u8, i64, p_i32, p_i64, i64,
    ]
    lib.get_2d3d.restype = i64
    lib.triangulation_tracks.argtypes = [
        i64, i64, p_i64, p_i32, p_i32, p_i64, p_u8, p_u8, i64, i64, i64,
        p_i32, p_i64, p_i32,
    ]
    lib.triangulation_tracks.restype = i64
    lib.find_merge_partners_batch.argtypes = [
        p_i32, p_i64, i64, p_i64, p_i64, p_i32, p_i32, p_i64, p_u8, p_i64,
    ]
    lib.find_merge_partners_batch.restype = None
    lib.completion_candidates_batch.argtypes = [
        p_i32, p_i64, i64, p_i64, p_i32, p_i32, p_i64, p_u8, i64, i64,
        p_i32, p_i64, p_i32, ctypes.c_int32,
    ]
    lib.completion_candidates_batch.restype = i64
    _lib = lib
    return _lib


def available() -> bool:
    """True once the library is loaded; a failed build raises instead."""
    return get_lib() is not None
