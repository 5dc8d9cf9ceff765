"""Builds each csrc/*.cu into a shared library at first use and loads it.

nvcc compiles each source with a plain C interface (no PyTorch headers, so
a build takes seconds) into its own library under `build/monocularsfm_torch/`
at the root of the checkout; the file name carries a hash of the source,
so an edited kernel is rebuilt.  A library is built when one of its entry
points is first called, so a caller pays only for the kernels it runs
(bundle adjustment builds csrc/schur.cu alone); `build()` builds them all
at once, one nvcc process per source, all started together.  `build_log`
keeps what ptxas said of each kernel (registers, shared memory, spills).
The libraries are loaded with ctypes and every entry point gets its
argtypes.  A failed build or load raises: there is no fallback.
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
    "sfm_match_tile": ([_P, _P, _I, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P,
                        _P, _P, _I, _I, _P], _I),
    "sfm_schur_product": ([_P] * 13 + [_I] * 4 + [_P], _I),
}
# The entry points of each source's library.
_LIBRARIES = {
    "blur": ("sfm_blur_v", "sfm_blur_h", "sfm_blur_vh"),
    "match_tile": ("sfm_match_tile",),
    "schur": ("sfm_schur_product",),
}
_SOURCE_OF = {fn: src for src, fns in _LIBRARIES.items() for fn in fns}

build_seconds = None  # wall time of the last build this process made, if any
build_log = ""        # the compilers' messages of this process's builds


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = shutil.which("nvcc")
    if cand is None and CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
    if cand is None or not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return cand


def library_path(name: str) -> pathlib.Path:
    """Where the library of csrc/<name>.cu is built."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libsfm_{name}_{h.hexdigest()[:16]}.so"


def _run(cmds) -> list[str]:
    """Run the commands together; wait for all, then raise if any failed.
    Returns each one's messages."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    results = [proc.communicate() for proc in procs]
    for cmd, proc, (stdout, stderr) in zip(cmds, procs, results):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{stdout}\n{stderr}")
    return [stdout + stderr for stdout, stderr in results]


def build(names=None) -> list[pathlib.Path]:
    """Compile the libraries of csrc/<name>.cu for `names` (default: every
    source) unless these exact builds exist already; returns their paths.
    The compilers' messages of each build stay beside its library, in the
    same name with `.log`."""
    global build_seconds, build_log
    names = list(names or _LIBRARIES)
    outs = [library_path(n) for n in names]
    todo = [(n, out, out.with_suffix(f".{os.getpid()}.tmp"))
            for n, out in zip(names, outs) if not out.exists()]
    if not todo:
        return outs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    try:
        logs = _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                      str(CSRC / f"{n}.cu")] for n, _, tmp in todo])
        for (_, out, tmp), log in zip(todo, logs):
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
    finally:
        for _, _, tmp in todo:
            tmp.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    build_log += "".join(logs)
    return outs


class _Kernels:
    """The entry points, each loaded (its library built) on first use."""

    def __getattr__(self, fn: str):
        if fn not in _SOURCE_OF:
            raise AttributeError(fn)
        name = _SOURCE_OF[fn]
        handle = ctypes.CDLL(str(build([name])[0]))
        for entry in _LIBRARIES[name]:
            f = getattr(handle, entry)
            f.argtypes, f.restype = _SIGNATURES[entry]
            setattr(self, entry, f)
        return getattr(self, fn)


_kernels = _Kernels()


def lib() -> _Kernels:
    """The kernels' entry points (each library built on first use)."""
    return _kernels


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        import torch

        raise RuntimeError(f"{what}: CUDA error {torch.cuda.CudaError(code)}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
