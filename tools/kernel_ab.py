"""The port's blur kernels against an earlier version of them, on one card.

    python3 tools/kernel_ab.py --old DIR [--out FILE]

DIR is an earlier checkout of the repository whose
monocularsfm_torch/csrc holds the blur as two passes, with the C interface
of that version: sfm_blur_v with host taps, sfm_blur_h with device taps.
The script builds those sources with nvcc next to the current ones and
times, at the octave-0 stack (4, 1920, 2560) with C=5/T=31 and with
C=1/T=9, in turns (old, new, new, old):
  - the old pair blur_h(blur_v(x)) against the fused blur_vh;
  - the old blur_h against the new one;
  - the old blur_v against the new one (the same kernel: the spread of
    the measurement).
It checks that each new result equals the old one bit for bit, and prints
(and writes to FILE) one JSON object with every time, the bound of the
work (monocularsfm_torch/utils/roofline.py) and the library call's time.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import pathlib
import subprocess
import sys

import torch
import torch.nn.functional as F

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (time_ms, the shapes)
from monocularsfm_torch.ops import _build, blur  # noqa: E402
from monocularsfm_torch.ops.sift import INIT_SIGMA, SIGMA0, _OCT_KER, gaussian_kernel1d  # noqa: E402
from monocularsfm_torch.utils import roofline  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int
REPS = 20


def build_old(old_dir: pathlib.Path) -> ctypes.CDLL:
    srcs = sorted((old_dir / "monocularsfm_torch" / "csrc").glob("*.cu"))
    if not srcs:
        raise SystemExit(f"no CUDA sources under {old_dir}/monocularsfm_torch/csrc")
    out = REPO / "build" / "kernel_ab" / "libsfm_kernels_old.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    cmd = [_build._nvcc(), *flags, "-shared", "-o", str(out), *map(str, srcs)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
    lib = ctypes.CDLL(str(out))
    for fn in (lib.sfm_blur_v, lib.sfm_blur_h):
        fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
        fn.restype = _I
    return lib


def old_pass(fn, x, taps_ptr, C, T):
    """One old pass: (B, H, W) -> (B, C, H, W) or (B, C, H, W) -> itself."""
    B, H, W = x.shape[0], x.shape[-2], x.shape[-1]
    out = torch.empty((B, C, H, W), device=x.device)
    code = fn(x.data_ptr(), taps_ptr, out.data_ptr(), B, H, W, C, T,
              _build.stream_ptr(x.device))
    if code:
        raise RuntimeError(f"old blur kernel: CUDA error {code}")
    return out


def in_turns(old_fn, new_fn):
    """Old, new, new, old; the four times and the two means, in ms."""
    t = [chip_smoke.time_ms(f, REPS) for f in (old_fn, new_fn, new_fn, old_fn)]
    return {"old_ms": (t[0] + t[3]) / 2, "new_ms": (t[1] + t[2]) / 2,
            "turns_ms": t}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True, type=pathlib.Path)
    ap.add_argument("--out", type=pathlib.Path,
                    default=REPO / "chiprun_out" / "kernel_ab.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    import monocularsfm_torch  # noqa: F401  (precision pins)

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    old = build_old(args.old)
    _build.lib()
    result = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda}

    base = torch.rand(chip_smoke.BLUR_SHAPE,
                      generator=torch.Generator(dev).manual_seed(0), device=dev)
    kb = gaussian_kernel1d(math.sqrt(SIGMA0 ** 2 - 4.0 * INIT_SIGMA ** 2))
    for ct, taps_np in (("C=5 T=31", _OCT_KER), ("C=1 T=9", kb[None])):
        host = torch.as_tensor(taps_np)
        taps_dev = host.to(dev)
        C, T = host.shape
        r = (T - 1) // 2
        hp, dp = host.data_ptr(), taps_dev.data_ptr()

        def old_v():
            return old_pass(old.sfm_blur_v, base, hp, C, T)

        v = old_v()

        def old_h():
            return old_pass(old.sfm_blur_h, v, dp, C, T)

        def old_pair():
            return old_pass(old.sfm_blur_h, old_v(), dp, C, T)

        pad_h = F.pad(v, (r, r, 0, 0), mode="replicate")
        pad_2d = F.pad(base[:, None], (r, r, r, r), mode="replicate")
        k2d = (taps_dev[:, :, None] * taps_dev[:, None, :])[:, None]
        cases = (
            ("blur_vh vs the pair", old_pair, lambda: blur.blur_vh(base, host),
             roofline.blur_multi_work, lambda: F.conv2d(pad_2d, k2d)),
            ("blur_h", old_h, lambda: blur.blur_h(v, host),
             roofline.blur_h_work,
             lambda: F.conv2d(pad_h, taps_dev[:, None, None, :], groups=C)),
            ("blur_v (unchanged)", old_v, lambda: blur.blur_v(base, host),
             roofline.blur_v_work, None),
        )
        for name, old_fn, new_fn, work, library in cases:
            equal = torch.equal(old_fn(), new_fn())
            row = in_turns(old_fn, new_fn)
            row["bound_ms"], row["bound_by"] = roofline.bound(
                *work(*base.shape, C, T), "fp32")
            row["bound_share_new"] = row["bound_ms"] / row["new_ms"]
            row["library_ms"] = (chip_smoke.time_ms(library, REPS)
                                 if library else None)
            row["new_equals_old"] = equal
            result[f"{name} {ct}"] = row
            print(f"{name} {ct}", json.dumps(row), file=sys.stderr, flush=True)
            if not equal:
                raise SystemExit(f"{name} {ct}: the new result differs from the old")

    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
