"""Runs the port's main computations twice each on one input, in one
process, and compares the two runs bit for bit.

    python3 tools/repeat_check.py [--device cuda] [--small] [--out FILE]

Items, in this order:
  dense     dense BA on chip_smoke.py's ring (128 cameras, 40k points,
            track 8), 50 LM iterations at tolerances 0;
  pcg       PCG BA on its 1024-camera ring (200k points, track 6 in rows
            of 3), 10 LM iterations x 50 CG steps at tolerances 0;
  pipeline  `sfm-torch` extract, match, reconstruct and export of 16
            views rendered as chip_smoke.py renders its pipeline's
            (1280x960): the database's features and match rows,
            `colmap/*.txt` and `cloud.ply` (global BA dense to 8 views,
            PCG beyond);
  vocab     train_visual_vocab with 4096 words on that pipeline's
            descriptors (every descriptor of the 16 views).

For each it logs the largest absolute difference between the two runs,
the LM iterations and CG steps (BA), and the registered images and points
(pipeline); the last line of standard output is one JSON object with all
of it and the card's name and power limit.  Exits 1 when any item's two
runs differ.  `--device cpu --small` runs every item at a tiny size for a
rehearsal on the CPU.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile

import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as S  # noqa: E402  (the smoke's sizes and helpers)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card(device: str) -> str:
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="tiny sizes, for a rehearsal on the CPU")
    ap.add_argument("--out", type=pathlib.Path,
                    default=REPO / "build" / "repeat_check.json")
    args = ap.parse_args()
    dev = args.device
    if torch.device(dev).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but torch.cuda.is_available() is false")
    import monocularsfm_torch  # noqa: F401  (precision pins)
    from monocularsfm_torch.utils.ring_problem import ring_problem
    from monocularsfm_torch.utils.synthetic import render_multiplane_images

    if args.small:
        dense = (8, 400, 4, 2)
        pcg = (12, 600, 6, 3)
        views, w, h, words = 4, 320, 240, 64
    else:
        dense = (S.BA_CAMS, S.BA_POINTS, S.BA_TRACK, 2)
        pcg = (S.PCG_CAMS, S.PCG_POINTS, S.PCG_TRACK, 3)
        views, w, h, words = 16, S.MP_W, S.MP_H, 4096
    result = {"card": card(dev), "device": dev, "small": args.small}
    with tempfile.TemporaryDirectory() as tmp:
        prob = ring_problem(*dense[:3], seed=dense[3])[0].to(dev)
        result["dense"] = S.ba_twice(prob, dev, max_iterations=S.BA_ITERS,
                                     **S.FIXED_WORK)
        prob = ring_problem(*pcg[:3], seed=pcg[3], row_width=3)[0].to(dev)
        result["pcg"] = S.ba_twice(prob, dev, max_iterations=S.PCG_LM_ITERS,
                                   solve_mode="pcg", pcg_iters=S.PCG_INNER,
                                   **S.FIXED_WORK)
        del prob
        imgs, K, _, _ = render_multiplane_images(
            scene_seed=S.MP_SEED, num_cameras=views, width=w, height=h,
            arc_deg=S.MP_ARC_PER_VIEW * views)
        result["pipeline"] = S.pipeline_twice(imgs, K, dev, tmp)
        bank = S.descriptor_bank(result["pipeline"].pop("database"))
        result["vocab"] = S.vocab_twice(bank, dev, words)
    items = ("dense", "pcg", "pipeline", "vocab")
    for item in items:
        log(f"[{item}] {json.dumps(result[item])}")
    result["equal"] = all(result[i]["equal"] for i in items)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    sys.exit(0 if result["equal"] else 1)


if __name__ == "__main__":
    main()
