"""Where the fused blur's time goes: variants of csrc/blur.cu.

    python3 tools/blur_ablation.py [--out FILE]

Builds variants of the fused kernel (sfm_blur_vh) from the current source
with nvcc and times each at the octave-0 stack (4, 1920, 2560), with
C=5/T=31 and with C=1/T=9, on one card:
  full           the kernel as it is;
  no_h           the horizontal pass reduced to its first tap (its loads
                 and FMAs mostly gone; the stores stay);
  no_v           the vertical pass reduced to copies of its last rows;
  no_taps        both, which leaves the slab copy, V's stores and the
                 output stores;
  no_out         the output stores skipped (a never-true test keeps the
                 sums);
  no_copy        the slab copies skipped (the sums run on stale shared
                 memory);
  tile variants  other tile shapes at C=5/T=31, named rows<TH>_t<threads>
                 _rv<rows of a vertical thread>, with _np where the blocks
                 are not persistent (one tile each), and at C=1/T=9 the
                 same names prefixed c1_.
The first five compute wrong values: they exist to split the time.  All
are cut from the source at marked lines; the script stops if one is
missing.  It also samples the SM clock and the power draw (nvidia-smi)
while the full kernel runs, and times two yardsticks of the card's memory
rate: zeroing the (4, 5, 1920, 2560) output, and blur_v, which reads the
base and writes that output.  Prints one JSON object (and writes it to
FILE) with each variant's times in ms, the ptxas register notes, the
clocks and the card's name and power limit.
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

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (time_ms, the shapes)
from monocularsfm_torch.ops import _build, blur  # noqa: E402
from monocularsfm_torch.ops.sift import INIT_SIGMA, SIGMA0, _OCT_KER, gaussian_kernel1d  # noqa: E402

H_TAPS = ("      for (int e = 0; e < kHVec; ++e) acc[e] = "
          "fmaf(kt, w[off + t + e], acc[e]);\n")
H_FIRST = ("      for (int e = 0; e < kHVec; ++e) acc[e] = "
           "t ? acc[e] : fmaf(kt, w[off + e], acc[e]);\n")
V_TAPS = ("          for (int q = 0; q < RV; ++q) acc[q][c] = "
          "fmaf(kt, w[q], acc[q][c]);\n")
V_COPY = "          for (int q = 0; q < RV; ++q) acc[q][c] = w[q] + kt;\n"
STORE = "      if (y >= rows) continue;\n"
NO_STORE = "      if (y >= rows || acc[0] != -1.25f) continue;\n"
COPY = "    copy_tile<NT>(in + (size_t)(rest / tiles_y) * plane, slab, sw, H, W,\n"
NO_COPY = ("    if (tile < 0) copy_tile<NT>(in + (size_t)(rest / tiles_y) * plane, "
           "slab, sw, H, W,\n")
# The tile knobs: fused_rows, fused_threads, fused_vrows, fused_persistent.
ROWS = "  return C == 5 && T == 31 ? 24 : (C == 1 && T == 9 ? 32 : 8);\n"
THREADS = "  return C == 5 && T == 31 ? 384 : 256;\n"
VROWS = "  return C == 5 && T == 31 ? 4 : 2;\n"
PERSISTENT = "  return C == 5 && T == 31;\n"
MARKERS = (H_TAPS, V_TAPS, STORE, COPY, ROWS, THREADS, VROWS, PERSISTENT)


def tile(src: str, rows: int, threads: int, vrows: int, persistent: bool,
         c1: bool = False) -> str:
    """The source with another tile at C=5/T=31, or at C=1/T=9 (`c1`)."""
    p = str(persistent).lower()
    if c1:
        knobs = {ROWS: f"C == 5 && T == 31 ? 24 : (C == 1 && T == 9 ? {rows} : 8)",
                 THREADS: f"C == 5 && T == 31 ? 384 : (C == 1 && T == 9 ? {threads} : 256)",
                 VROWS: f"C == 5 && T == 31 ? 4 : (C == 1 && T == 9 ? {vrows} : 2)",
                 PERSISTENT: f"(C == 5 && T == 31) || (C == 1 && T == 9 && {p})"}
    else:
        knobs = {ROWS: f"C == 5 && T == 31 ? {rows} : (C == 1 && T == 9 ? 32 : 8)",
                 THREADS: f"C == 5 && T == 31 ? {threads} : 256",
                 VROWS: f"C == 5 && T == 31 ? {vrows} : 2",
                 PERSISTENT: f"C == 5 && T == 31 && {p}"}
    for marker, expr in knobs.items():
        src = src.replace(marker, f"  return {expr};\n")
    return src


TILES = [(24, 384, 2, True), (24, 384, 4, False), (16, 256, 2, True),
         (16, 256, 4, True)]
C1_TILES = [(32, 256, 2, True), (24, 384, 2, False)]


def variants(src: str) -> dict[str, str]:
    for marker in MARKERS:
        if src.count(marker) != 1:
            raise SystemExit(f"blur.cu lacks the line {marker.strip()!r}")
    out = {
        "full": src,
        "no_h": src.replace(H_TAPS, H_FIRST),
        "no_v": src.replace(V_TAPS, V_COPY),
        "no_taps": src.replace(H_TAPS, H_FIRST).replace(V_TAPS, V_COPY),
        "no_out": src.replace(STORE, NO_STORE),
        "no_copy": src.replace(COPY, NO_COPY),
    }
    for c1, tiles in ((False, TILES), (True, C1_TILES)):
        for rows, threads, vrows, persistent in tiles:
            name = (f"{'c1_' if c1 else ''}rows{rows}_t{threads}_rv{vrows}"
                    f"{'' if persistent else '_np'}")
            out[name] = tile(src, rows, threads, vrows, persistent, c1)
    return out


def clocks_while(run, seconds: float = 1.5) -> list[str]:
    """nvidia-smi samples of the SM clock and power draw during a loop of
    `run`."""
    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    reps = max(1, int(seconds * 1e3 / start.elapsed_time(end)))
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader",
         "-lms", "200"], stdout=subprocess.PIPE, text=True)
    try:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate()
    return [line.strip() for line in out.splitlines() if line.strip()]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=pathlib.Path,
                    default=REPO / "chiprun_out" / "blur_ablation.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    src = (REPO / "monocularsfm_torch" / "csrc" / "blur.cu").read_text()
    base = torch.rand(chip_smoke.BLUR_SHAPE,
                      generator=torch.Generator("cuda").manual_seed(0), device="cuda")
    B, H, W = base.shape
    kb = gaussian_kernel1d(math.sqrt(SIGMA0 ** 2 - 4.0 * INIT_SIGMA ** 2))
    taps = {"C=5 T=31": torch.as_tensor(_OCT_KER), "C=1 T=9": torch.as_tensor(kb[None])}
    out = torch.empty((B, 5, H, W), device="cuda")
    result = {"card": smi, "shape": [B, H, W]}
    work = REPO / "build" / "blur_ablation"
    for name, text in variants(src).items():
        d = work / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "blur.cu").write_text(text)
        so = d / "libvariant.so"
        res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                              str(so), str(d / "blur.cu")],
                             capture_output=True, text=True)
        if res.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{res.stderr}")
        lines = res.stderr.splitlines()
        notes = [lines[i + 2].split("info    : ")[-1] for i, line in enumerate(lines)
                 if "blur_vh_kernelILi" in line and i + 2 < len(lines)]
        fn = ctypes.CDLL(str(so)).sfm_blur_vh
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + \
            [ctypes.c_int] * 5 + [ctypes.c_void_p]
        row = {"ptxas (runtime, 5/31, 1/9)": notes}
        for ct, k in taps.items():
            C, T = k.shape

            def run():
                code = fn(base.data_ptr(), k.data_ptr(), out.data_ptr(), C * H * W,
                          B, H, W, C, T, torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"{name}: CUDA error {code}")

            times = [chip_smoke.time_ms(run, 20) for _ in range(2)]
            row[ct] = {"ms": sum(times) / 2, "runs_ms": times}
            if name == "full" and C == 5:
                row["clocks_sm_power"] = clocks_while(run)
        result[name] = row
        print(name, json.dumps({ct: row[ct]["ms"] for ct in taps}), file=sys.stderr,
              flush=True)
    result["zero_output_ms"] = chip_smoke.time_ms(out.zero_, 20)
    result["blur_v_ms"] = chip_smoke.time_ms(
        lambda: blur.blur_v(base, taps["C=5 T=31"]), 20)
    print("yardsticks: zero the output", result["zero_output_ms"], "blur_v",
          result["blur_v_ms"], file=sys.stderr, flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
