"""The port's BA scaling table: one card / N ranks on the host / 2 ranks.

The PyTorch counterpart of tools/scaling_table.py, on the same problem: the
bench's camera ring at 256 cameras / 50k points / track 6, PCG with 10 LM
iterations of 50 CG steps.  Each mode prints one JSON line with the JAX
script's keys (label, backend, devices, processes, cams, points, obs,
lm_iters_per_sec, rmse_final) and the card's nvidia-smi name and power
limit; the sharded modes add the wall of each solve and the seconds its
ranks spent inside collectives (the device synchronised around each).

  python tools/scaling_table_torch.py --mode card [--device cuda]
      one device, no process group (the JAX script's `tpu` row)
  python tools/scaling_table_torch.py --mode host [--ranks 8]
      N gloo ranks on the CPU (its 8-virtual-device row)
  python tools/scaling_table_torch.py --mode dcn [--device cuda]
      2 ranks on --device: on a machine with one card, two gloo ranks
      sharing it, so the row measures the sharded code's overhead there,
      not scaling (its 2-process row)

--cams/--points shrink the problem for a quick check.  A sharded row runs
landmark-sharded BA (parallel/distributed_ba.py) in ranks started by
parallel/mesh.py::spawn; each solve follows a warm-up solve of 2 LM
iterations.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

CAMS = 256
POINTS = 50_000
TRACK = 6
SEED = 3
LM_ITERS = 10
PCG_INNER = 50
KW = dict(max_iterations=LM_ITERS, solve_mode="pcg", pcg_iters=PCG_INNER)


def measure_card(cams: int, points: int, device) -> dict:
    """bundle_adjust on one device: a warm-up solve, then the timed one."""
    import torch

    from monocularsfm_torch.optim import bundle_adjust
    from monocularsfm_torch.utils.card import sync
    from monocularsfm_torch.utils.ring_problem import ring_problem

    prob, nobs = ring_problem(cams, points, TRACK, seed=SEED)
    prob = prob.to(device)
    bundle_adjust(prob, device=device, **dict(KW, max_iterations=2))
    sync(device)
    t0 = time.perf_counter()
    out = bundle_adjust(prob, device=device, **KW)
    sync(device)
    dt = time.perf_counter() - t0
    return {"backend": torch.device(device).type, "devices": 1,
            "processes": 1, "obs": nobs, "iterations": out["iterations"],
            "cg_steps": out["cg_steps"], "wall_s": dt,
            "rmse_final": float(out["rmse_final"])}


def measure_ranks(n: int, cams: int, points: int, device,
                  timeout: float) -> dict:
    """Landmark-sharded BA over n spawned ranks on `device`."""
    from monocularsfm_torch.parallel.mesh import spawn

    res = spawn(n, [("monocularsfm_torch.parallel.dryrun:ring_ba",
                     (cams, points, TRACK, SEED, device), KW)],
                device=device, timeout=timeout)
    r = res[0][0]
    r.update(devices=n, processes=n,
             collective_s_per_rank=[rank[0]["collective_s"] for rank in res])
    return r


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=["card", "host", "dcn"], required=True)
    ap.add_argument("--device", default="cuda",
                    help="device of the card and dcn rows (default cuda)")
    ap.add_argument("--ranks", type=int, default=8, help="host row's ranks")
    ap.add_argument("--cams", type=int, default=CAMS)
    ap.add_argument("--points", type=int, default=POINTS)
    ap.add_argument("--timeout", type=float, default=3600.0)
    args = ap.parse_args(argv)

    from monocularsfm_torch.reconstruction.map_builder import resolve_device
    from monocularsfm_torch.utils.card import card_line

    device = "cpu" if args.mode == "host" else args.device
    resolve_device(device)
    if args.mode == "card":
        r = measure_card(args.cams, args.points, device)
        label = f"1 device ({device})"
    elif args.mode == "host":
        r = measure_ranks(args.ranks, args.cams, args.points, device, args.timeout)
        label = f"1 host, {args.ranks} gloo ranks (CPU)"
    else:
        r = measure_ranks(2, args.cams, args.points, device, args.timeout)
        label = f"2 ranks on {device} ({r['backend']})"
    print(json.dumps({
        "label": label, "backend": r["backend"], "devices": r["devices"],
        "processes": r["processes"], "cams": args.cams, "points": args.points,
        "obs": r["obs"], "lm_iters_per_sec": r["iterations"] / r["wall_s"],
        "rmse_final": r["rmse_final"], "card": card_line(device),
        **{k: r[k] for k in ("iterations", "cg_steps", "wall_s",
                             "collective_s_per_rank") if k in r},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
