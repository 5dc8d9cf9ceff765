"""The port's redesigned kernels against their first versions, on one card.

    python3 tools/kernel_ab.py --old DIR [--out FILE]

DIR is an earlier checkout of the repository whose
monocularsfm_torch/csrc holds the first CUDA versions of the kernels (the
C interface of that version: sfm_blur_v with device taps, sfm_match_tile
writing row and column partials).  The script builds those sources with
nvcc next to the current ones and times, at the main path's shapes and in
turns (old, new, new, old): blur_v at the octave-0 stack (4, 1920, 2560)
with C=5/T=31 and with C=1/T=9, and the matcher over 16 pairs at capacity
8192: the kernel alone (its bare launch and output allocation) and the
statistics whole (kernel + merge of its partials; both without the
wrapper's input checks, which read the pair ids back to the host).  It
checks that the new blur_v equals the old one bit for bit and that the
two matchers give the same statistics, and prints (and
writes to FILE) one JSON object with every time, the bound of the work
(monocularsfm_torch/utils/roofline.py) and the library call's time.
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

import chip_smoke  # noqa: E402  (time_ms, match_bank, the shapes)
from monocularsfm_torch.ops import _build, blur, match_kernel  # noqa: E402
from monocularsfm_torch.ops.sift import INIT_SIGMA, SIGMA0, _OCT_KER, gaussian_kernel1d  # noqa: E402
from monocularsfm_torch.utils import roofline  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int


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
    lib.sfm_blur_v.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
    lib.sfm_match_tile.argtypes = [_P] * 9 + [_I, _I, _I, _P]
    lib.sfm_blur_v.restype = lib.sfm_match_tile.restype = _I
    return lib


def old_blur_v(lib, base, taps_dev):
    B, H, W = base.shape
    C, T = taps_dev.shape
    out = torch.empty((B, C, H, W), device=base.device)
    code = lib.sfm_blur_v(base.data_ptr(), taps_dev.data_ptr(), out.data_ptr(),
                          B, H, W, C, T, _build.stream_ptr(base.device))
    if code:
        raise RuntimeError(f"old sfm_blur_v: CUDA error {code}")
    return out


def old_match_partials(lib, bank, mask, pairs):
    P, (I, N, D) = pairs.shape[0], bank.shape
    bufs = [torch.empty((P, N // 128, N), device=bank.device,
                        dtype=torch.int32 if k in (1, 4) else torch.float32)
            for k in range(6)]
    code = lib.sfm_match_tile(bank.data_ptr(), mask.data_ptr(), pairs.data_ptr(),
                              *(b.data_ptr() for b in bufs), P, N, D,
                              _build.stream_ptr(bank.device))
    if code:
        raise RuntimeError(f"old sfm_match_tile: CUDA error {code}")
    return bufs[:3], bufs[3:]


def new_match_partials(bank, mask, pairs):
    """The new kernel's bare launch, allocating its outputs as the old
    one's does (no input checks, which read pair ids back to the host)."""
    P, (I, N, D) = pairs.shape[0], bank.shape
    f32, i32 = dict(device=bank.device), dict(device=bank.device, dtype=torch.int32)
    rows = (torch.empty((P, N), **f32), torch.empty((P, N), **i32),
            torch.empty((P, N), **f32))
    cols = (torch.empty((P, N // 128, N), **f32),
            torch.empty((P, N // 128, N), **i32),
            torch.empty((P, N // 128, N), **f32))
    match_kernel.launch(bank, mask, pairs, rows, cols)
    return rows, cols


def new_match_stats(bank, mask, pairs):
    rows, cols = new_match_partials(bank, mask, pairs)
    return rows + match_kernel._merge_partials(*cols)


def old_match_stats(lib, bank, mask, pairs):
    rows, cols = old_match_partials(lib, bank, mask, pairs)
    return match_kernel._merge_partials(*rows) + match_kernel._merge_partials(*cols)


def in_turns(old_fn, new_fn, reps):
    """Old, new, new, old; the four times and the two means, in ms."""
    t = [chip_smoke.time_ms(f, reps) for f in (old_fn, new_fn, new_fn, old_fn)]
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
    for name, taps_np in (("blur_v C=5 T=31", _OCT_KER), ("blur_v C=1 T=9", kb[None])):
        host = torch.as_tensor(taps_np)
        taps_dev = host.to(dev)
        diff = (old_blur_v(old, base, taps_dev)
                - blur.blur_v(base, host)).abs().max().item()
        r = (taps_dev.shape[1] - 1) // 2
        padded = F.pad(base[:, None], (0, 0, r, r), mode="replicate")
        wk = taps_dev[:, None, :, None]
        row = in_turns(lambda: old_blur_v(old, base, taps_dev),
                       lambda: blur.blur_v(base, host), 20)
        nbytes, ops = roofline.blur_v_work(*base.shape, *taps_dev.shape)
        row["bound_ms"], row["bound_by"] = roofline.bound(nbytes, ops, "fp32")
        row["library_ms"] = chip_smoke.time_ms(lambda: F.conv2d(padded, wk), 20)
        row["max_abs_diff_old_new"] = diff
        result[name] = row
        print(name, json.dumps(row), file=sys.stderr, flush=True)

    bank, mask, pairs = chip_smoke.match_bank(dev)
    new_stats = match_kernel.match_stats(bank, mask, pairs)
    old_stats = old_match_stats(old, bank, mask, pairs)
    agree = {"max_abs_diff": max((a - b).abs().max().item() for a, b in
                                 zip(new_stats, old_stats) if a.is_floating_point()),
             "argmax_agreement": min((new_stats[i] == old_stats[i]).float().mean().item()
                                     for i in (1, 4))}
    valid = mask.sum(1).tolist()
    nbytes, ops = roofline.match_work(valid, pairs.tolist(), bank.shape[1])
    bound_ms, bound_by = roofline.bound(nbytes, ops, "bf16")
    A, B = bank[pairs[:, 0].long()], bank[pairs[:, 1].long()]
    lib_ms = chip_smoke.time_ms(lambda: torch.bmm(A, B.transpose(1, 2)), 10)
    for name, o, n in (
            ("match_tile kernel", lambda: old_match_partials(old, bank, mask, pairs),
             lambda: new_match_partials(bank, mask, pairs)),
            ("match_stats", lambda: old_match_stats(old, bank, mask, pairs),
             lambda: new_match_stats(bank, mask, pairs))):
        row = in_turns(o, n, 5)
        row.update(bound_ms=bound_ms, bound_by=bound_by,
                   library_ms_product_alone=lib_ms, pairs=len(pairs),
                   capacity=bank.shape[1], old_vs_new=agree)
        result[name] = row
        print(name, json.dumps(row), file=sys.stderr, flush=True)

    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
