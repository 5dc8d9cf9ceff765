"""The extract + match slice of two checkouts, in turns, on one card.

    python3 tools/stage_ab.py --old DIR [--out FILE]

Runs `chip_smoke.phase_slice` (8 rendered 1280x960 images: `sfm-torch
extract` and `match` after a warm-up run, with its checks) of the earlier
checkout DIR and of this one, each in its own process, in the order old,
new, new, old, and prints (and writes to FILE) one JSON object with each
run's extract images/s, match pairs/s and kernel launches.  A stage rate
compares only within one such call: host speed differs between machines.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
CODE = ("import json, chip_smoke\n"
        "launches, ips, pps = chip_smoke.phase_slice('cuda')\n"
        "print(json.dumps({'extract_images_per_s': ips, 'match_pairs_per_s': pps,"
        " 'launches': launches}))\n")


def run(root: pathlib.Path) -> dict:
    res = subprocess.run([sys.executable, "-c", CODE], cwd=root,
                         capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise SystemExit(f"slice in {root} failed:\n{res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True, type=pathlib.Path)
    ap.add_argument("--out", type=pathlib.Path,
                    default=REPO / "chiprun_out" / "stage_ab.json")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    runs = []
    for name, root in (("old", args.old.resolve()), ("new", REPO),
                       ("new", REPO), ("old", args.old.resolve())):
        r = run(root)
        runs.append({"tree": name, **r})
        print(name, json.dumps(r), file=sys.stderr, flush=True)
    result = {"card": smi, "runs": runs}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
