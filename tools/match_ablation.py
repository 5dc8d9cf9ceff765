"""Where the matcher kernel's time goes: variants of csrc/match_tile.cu.

    python3 tools/match_ablation.py [--out FILE]

Builds four variants of the kernel from the current source with nvcc and
times each over the main path's batch (16 pairs at capacity 8192, the
smoke's descriptors), on one card:
  full       the kernel as it is;
  rows_only  without the column fold (the row fold still stores the tile
             to shared memory);
  mma_only   TMA loads and wgmma products, the epilogue reduced to one
             maximum per tile;
  no_mma     the whole epilogue on synthetic values, no wgmma.
Variants other than `full` compute wrong statistics: they exist to split
the time.  They are cut from the source at the epilogue's two fold calls
and the wgmma issue line; the script stops if one is missing.  Prints one JSON object (and
writes it to FILE) with each variant's time in ms, the ptxas register and
serialization notes, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (time_ms, match_bank)
from monocularsfm_torch.ops import _build  # noqa: E402

CALL_ROWS = "    fold_rows(acc, cm, col0);\n"
CALL_COLS = "    fold_column(col_ok, j, col0, row_base, ct1, ci1, ct2);\n"
WGMMA = "    wgmma_m64n128k16(acc, sw128_desc(a + off), sw128_desc(b + off), s > 0);\n  }"
REDUCE_MAX = ("    float m = acc[0];\n#pragma unroll\n"
              "    for (int i = 1; i < 64; ++i) m = fmaxf(m, acc[i]);\n"
              "    s0.v1 = fmaxf(s0.v1, m);\n")


def variants(src: str) -> dict[str, str]:
    for marker in (CALL_ROWS, CALL_COLS, WGMMA):
        if src.count(marker) != 1:
            raise SystemExit(f"match_tile.cu lacks the line {marker.strip()!r}")
    return {
        "full": src,
        "rows_only": src.replace(CALL_COLS, ""),
        "mma_only": src.replace(CALL_ROWS, REDUCE_MAX).replace(CALL_COLS, ""),
        "no_mma": src.replace(WGMMA, "  }\n#pragma unroll\n  for (int i = 0; i < 64; "
                              "++i) acc[i] = (float)((b >> 10) & 7) + 1e-3f * i;"),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=pathlib.Path,
                    default=REPO / "chiprun_out" / "match_ablation.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    src = (REPO / "monocularsfm_torch" / "csrc" / "match_tile.cu").read_text()
    bank, mask, pairs = chip_smoke.match_bank("cuda")
    P, (I, N, D) = pairs.shape[0], bank.shape
    f32 = dict(device="cuda")
    i32 = dict(device="cuda", dtype=torch.int32)
    outs = [torch.empty((P, N), **f32), torch.empty((P, N), **i32),
            torch.empty((P, N), **f32), torch.empty((P, N // 128, N), **f32),
            torch.empty((P, N // 128, N), **i32), torch.empty((P, N // 128, N), **f32)]
    result = {"card": smi, "pairs": P, "capacity": N}
    work = REPO / "build" / "match_ablation"
    for name, text in variants(src).items():
        d = work / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "match_tile.cu").write_text(text)
        so = d / "libvariant.so"
        res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                              str(so), str(d / "match_tile.cu")],
                             capture_output=True, text=True)
        if res.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{res.stderr}")
        notes = [line.split("info    : ")[-1] for line in res.stderr.splitlines()
                 if "match_tile_kernel" not in line or "C75" in line]
        notes = [n for n in notes if "C75" in n or "registers" in n]
        fn = ctypes.CDLL(str(so)).sfm_match_tile
        fn.argtypes, fn.restype = _build._SIGNATURES["sfm_match_tile"]

        def run():
            # One bank as both sides, as the batched matcher launches it.
            code = fn(bank.data_ptr(), mask.data_ptr(), I, N, bank.data_ptr(),
                      mask.data_ptr(), I, N, pairs.data_ptr(),
                      *(t.data_ptr() for t in outs), P, D,
                      torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"{name}: CUDA error {code}")

        times = [chip_smoke.time_ms(run, 10) for _ in range(2)]
        result[name] = {"ms": sum(times) / 2, "runs_ms": times, "ptxas": notes}
        print(name, json.dumps(result[name]), file=sys.stderr, flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
