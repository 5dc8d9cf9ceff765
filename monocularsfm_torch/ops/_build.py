"""Builds csrc/*.cu into one shared library at first use and loads it.

nvcc compiles the sources with a plain C interface (no PyTorch headers, so
the build takes seconds), one process per source, all started together,
then links them into `build/monocularsfm_torch/` at the root of the
checkout; the file name carries a hash of the sources, so an edited kernel
is rebuilt.  `build_log` keeps what ptxas said of each kernel (registers,
shared memory, spills).  The library is loaded with ctypes and every entry
point gets its argtypes.  A failed build or load raises: there is no
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "monocularsfm_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# Every exported entry point and its C signature.  Pointers and the stream
# are c_void_p (a bare Python int would be cut to 32 bits).
_SIGNATURES = {
    "sfm_blur_v": ([_P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
    "sfm_blur_h": ([_P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
    "sfm_blur_vh": ([_P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _I, _P], _I),
    "sfm_match_tile": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _P], _I),
    "sfm_error_string": ([_I], ctypes.c_char_p),
}

_lib = None
build_seconds = None  # wall time of the build this process made, if any
build_log = ""        # the compilers' messages of that build


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = shutil.which("nvcc")
    if cand is None and CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
    if cand is None or not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return cand


def _sources() -> list[pathlib.Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> pathlib.Path:
    h = hashlib.sha256()
    for s in _sources():
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libsfm_kernels_{h.hexdigest()[:16]}.so"


def _run(cmds) -> str:
    """Run the commands together; wait for all, then raise if any failed.
    Returns their messages."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    results = [proc.communicate() for proc in procs]
    for cmd, proc, (stdout, stderr) in zip(cmds, procs, results):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{stdout}\n{stderr}")
    return "".join(stdout + stderr for stdout, stderr in results)


def build() -> pathlib.Path:
    """Compile the kernels unless this exact build exists already."""
    global build_seconds, build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    nvcc, srcs = _nvcc(), _sources()
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in srcs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(srcs, objs)])
        log += _run([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    build_log = log
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = handle
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib().sfm_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
