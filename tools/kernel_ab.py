"""The port's kernels against an earlier version of them, on one card.

    python3 tools/kernel_ab.py --old DIR [--mode blur|match] [--out FILE]

DIR is an earlier checkout of the repository.  The script builds its
sources with nvcc next to the current ones and times old against new in
turns (old, new, new, old).

--mode blur (the default): DIR's monocularsfm_torch/csrc holds the blur as
two passes, with the C interface of that version: sfm_blur_v with host
taps, sfm_blur_h with device taps.  At the octave-0 stack (4, 1920, 2560)
with C=5/T=31 and with C=1/T=9:
  - the old pair blur_h(blur_v(x)) against the fused blur_vh;
  - the old blur_h against the new one;
  - the old blur_v against the new one (the same kernel: the spread of
    the measurement).

--mode match: DIR's csrc/match_tile.cu is kernel 3, with either C
interface: one bank for both sides, sfm_match_tile(bank, mask, pairs, 6
outputs, I, P, N, D, stream), or the current two sides (told apart by
the source's `bank_a` argument).  The old kernel against the current one,
each given the same bank as both sides, at 16 pairs at capacity 8192
(the main path's batch) and at one pair (P = 1, the single-pair
matcher's launch).

It checks that each new result (for the matcher: the row statistics and
the column partials) equals the old one bit for bit, and prints (and
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

import chip_smoke  # noqa: E402  (time_ms, the shapes)
from monocularsfm_torch.ops import _build, blur, match_kernel  # noqa: E402
from monocularsfm_torch.ops.sift import INIT_SIGMA, SIGMA0, _OCT_KER, gaussian_kernel1d  # noqa: E402
from monocularsfm_torch.utils import roofline  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int
REPS = 20


def build_old(old_dir: pathlib.Path, pattern: str) -> ctypes.CDLL:
    """DIR's csrc sources matching `pattern`, built into one library."""
    srcs = sorted((old_dir / "monocularsfm_torch" / "csrc").glob(pattern))
    if not srcs:
        raise SystemExit(f"no {pattern} under {old_dir}/monocularsfm_torch/csrc")
    out = REPO / "build" / "kernel_ab" / "libsfm_kernels_old.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    cmd = [_build._nvcc(), *flags, "-shared", "-o", str(out), *map(str, srcs)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
    return ctypes.CDLL(str(out))


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
    ap.add_argument("--mode", choices=("blur", "match"), default="blur")
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
    result = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda}
    (blur_ab if args.mode == "blur" else match_ab)(args.old, dev, result)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


def blur_ab(old_dir, dev, result):
    old = build_old(old_dir, "*.cu")
    for fn in (old.sfm_blur_v, old.sfm_blur_h):
        fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
        fn.restype = _I
    _build.lib()
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


def match_ab(old_dir, dev, result):
    old = build_old(old_dir, "match_tile.cu").sfm_match_tile
    src = (old_dir / "monocularsfm_torch" / "csrc" / "match_tile.cu").read_text()
    two_sided = "const void* bank_a" in src
    old.argtypes, old.restype = (_build._SIGNATURES["sfm_match_tile"] if two_sided
                                 else ([_P] * 9 + [_I] * 4 + [_P], _I))
    result["old_interface"] = "two sides" if two_sided else "one bank"
    _build.lib()
    bank, mask, pairs = chip_smoke.match_bank(dev)
    one = torch.tensor([[0, 1]], dtype=torch.int32, device=dev)
    for name, bank, mask, pairs in (("16 pairs x 8192", bank, mask, pairs),
                                    ("P = 1 x 8192", bank[:2], mask[:2], one)):
        I, N, D = bank.shape
        P = pairs.shape[0]
        new_out = match_kernel.match_tile_partials(bank, mask, pairs)
        old_out = tuple(tuple(torch.empty_like(t) for t in side) for side in new_out)

        def old_fn():
            outs = (t.data_ptr() for side in old_out for t in side)
            stream = _build.stream_ptr(bank.device)
            if two_sided:
                code = old(bank.data_ptr(), mask.data_ptr(), I, N, bank.data_ptr(),
                           mask.data_ptr(), I, N, pairs.data_ptr(), *outs, P, D,
                           stream)
            else:
                code = old(bank.data_ptr(), mask.data_ptr(), pairs.data_ptr(),
                           *outs, I, P, N, D, stream)
            if code:
                raise RuntimeError(f"old match_tile: CUDA error {code}")

        def new_fn():
            match_kernel.launch(bank, mask, pairs, *new_out)

        old_fn()
        new_fn()
        torch.cuda.synchronize()
        equal = all(torch.equal(x, y) for a, b in zip(old_out, new_out)
                    for x, y in zip(a, b))
        row = in_turns(old_fn, new_fn)
        row["new_over_old"] = row["new_ms"] / row["old_ms"]
        row["bound_ms"], row["bound_by"] = roofline.bound(*roofline.match_work(
            mask.sum(1).tolist(), pairs.tolist(), N), "bf16")
        row["bound_share_new"] = row["bound_ms"] / row["new_ms"]
        A, B = bank[pairs[:, 0].long()], bank[pairs[:, 1].long()]
        row["library_ms"] = chip_smoke.time_ms(lambda: torch.bmm(A, B.transpose(1, 2)), REPS)
        row["library_is"] = "bf16 torch.bmm of the product alone, not the same function"
        row["new_equals_old"] = equal
        result[f"match_tile {name}"] = row
        print(f"match_tile {name}", json.dumps(row), file=sys.stderr, flush=True)
        if not equal:
            raise SystemExit(f"match_tile {name}: the new result differs from the old")


if __name__ == "__main__":
    main()
