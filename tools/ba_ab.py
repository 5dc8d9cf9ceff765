"""Bundle adjustment of two checkouts, in turns, on one card; and the
camera and point sums of one LM iteration alone.

    python3 tools/ba_ab.py --old DIR [--reps 3] [--out FILE]

(1) The dense ring of `chip_smoke.phase_ba_dense` (128 cameras, 40k
points, track 8; 50 LM iterations) and the PCG ring of `phase_ba_pcg`
(1024 cameras, 200k points, track 6 in rows of 3; 10 LM iterations x 50 CG
steps), both at tolerances 0, are built once here and solved by the
earlier checkout DIR and by this one, each in its own process, in the
order old, new, new, old.  Each process runs a warm-up, then `--reps`
timed solves of each ring (LM its/s by the host clock around a
synchronised solve; whether the solves gave the same bits), then one more
solve under torch.profiler (device time by kernel, the busy share of the
solve's wall, the host ops' own CPU time, which the profiler inflates).

(2) In this process, with this checkout: the sums of one LM iteration at
both rings' shapes, U (O, 6, 6) and g_c (O, 6) to the cameras and V (O, 3,
3) and W^T x (O, 3) to the points, by `index_add_` (atomics) and by the
fixed-order sum of `utils/segment.py`: CUDA-event ms, the largest error
against a float64 sum, whether two calls give the same bits, and the
plan's build time and passes.

Prints (and writes to FILE) one JSON object, with the card's name and
power limit.  Times compare only within one call.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as S  # noqa: E402  (the rings, the fixed work, time_ms)

SOLVES = {
    "dense": dict(max_iterations=S.BA_ITERS),
    "pcg": dict(max_iterations=S.PCG_LM_ITERS, solve_mode="pcg",
                pcg_iters=S.PCG_INNER),
}

# Run in the root of either checkout: argv = problems file, reps, solves.
CODE = r"""
import hashlib, json, sys, time
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, ".")
from monocularsfm_torch.optim import BundleProblem, bundle_adjust

probs = torch.load(sys.argv[1])
reps = int(sys.argv[2])
solves, fixed = json.loads(sys.argv[3])
out = {}
for name, kw in solves.items():
    prob = BundleProblem(**{k: v.cuda() for k, v in probs[name].items()})
    kw = dict(kw, device="cuda", **fixed)
    bundle_adjust(prob, **dict(kw, max_iterations=2))
    rates, digests = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = bundle_adjust(prob, **kw)
        torch.cuda.synchronize()
        rates.append(r["iterations"] / (time.perf_counter() - t0))
        digests.append(hashlib.sha256(b"".join(
            r[k].cpu().numpy().tobytes() for k in ("R", "t", "X"))).hexdigest()[:16])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pr:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bundle_adjust(prob, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in pr.key_averages() if e.device_type == DeviceType.CUDA),
                  key=lambda k: -k[1])
    busy = sum(k[1] for k in kern)
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in pr.key_averages() if e.device_type == DeviceType.CPU),
                  key=lambda k: -k[1])
    out[name] = {"lm_iters_per_s": rates, "digests": digests,
                 "iterations": r["iterations"], "cg_steps": r["cg_steps"],
                 "profiled_wall_ms": wall * 1e3, "device_busy_ms": busy,
                 "busy_share": busy / (wall * 1e3),
                 "top_kernels": [(k[:90], ms, n) for k, ms, n in kern[:10]],
                 "top_host_ops": [(k[:60], ms, n) for k, ms, n in host[:10]]}
    del prob
print(json.dumps(out))
"""


def solve_in(root: pathlib.Path, problems: str, reps: int) -> dict:
    res = subprocess.run(
        [sys.executable, "-c", CODE, problems, str(reps),
         json.dumps([SOLVES, S.FIXED_WORK])],
        cwd=root, capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise SystemExit(f"solves in {root} failed:\n{res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def observation_ids(prob):
    """The cameras and points of the weighted observations, selected as
    bundle_adjust selects them."""
    P, T = prob.obs_cam.shape
    rows = torch.arange(P) if prob.point_rows is None else prob.point_rows
    pt_all = rows[:, None].expand(P, T).reshape(-1)
    cam_all = prob.obs_cam.reshape(-1)
    obs = (prob.obs_valid.reshape(-1) & prob.point_valid[pt_all]
           & prob.cam_valid[cam_all]).nonzero()[:, 0]
    return cam_all[obs], pt_all[obs], prob.R.shape[0], prob.X.shape[0]


def sum_methods(ids, vals, num):
    """The two sums of `vals` by `ids`, each a function of no arguments,
    and what the fixed-order one needs built."""
    from monocularsfm_torch.utils.segment import planned_sum, segment_plan

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = segment_plan(ids, num)
    build_ms = (time.perf_counter() - t0) * 1e3
    methods = {
        "index_add": lambda: torch.zeros((num,) + vals.shape[1:], device="cuda")
        .index_add_(0, ids, vals),
        "fixed_order": lambda: planned_sum(vals, plan),
    }
    return methods, {
        "plan_build_ms": build_ms, "plan_sorts": plan.order is not None,
        "plan_passes": [len(o) - 1 for o in plan.levels],
        "values_mb": vals.numel() * 4 / 1e6,
    }


def sums_alone(probs: dict) -> dict:
    """(2): both sums of one LM iteration."""
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, prob in probs.items():
        cam_o, pt_o, C, Pn = observation_ids(prob)
        res = {"observations": len(cam_o), "cameras": C, "points": Pn}
        for what, ids, num, shape in (("U", cam_o, C, (6, 6)), ("g_c", cam_o, C, (6,)),
                                      ("V", pt_o, Pn, (3, 3)), ("WTx", pt_o, Pn, (3,))):
            ids = ids.cuda()
            vals = torch.randn((len(ids),) + shape, generator=gen, device="cuda")
            methods, res[what] = sum_methods(ids, vals, num)
            ref = torch.zeros((num,) + shape, dtype=torch.float64).index_add_(
                0, ids.cpu(), vals.cpu().double())
            for m, fn in methods.items():
                a, b = fn(), fn()
                res[what][m] = {
                    "ms": S.time_ms(fn, reps=20),
                    "max_abs_err_vs_f64": float((a.cpu().double() - ref).abs().max()),
                    "repeats_bit_for_bit": bool(torch.equal(a, b)),
                }
        out[name] = res
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True, type=pathlib.Path)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", type=pathlib.Path,
                    default=REPO / "build" / "ba_ab.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    import monocularsfm_torch  # noqa: F401  (precision pins)
    from monocularsfm_torch.utils.ring_problem import ring_problem

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    t0 = time.perf_counter()
    probs = {
        "dense": ring_problem(S.BA_CAMS, S.BA_POINTS, S.BA_TRACK, seed=2)[0],
        "pcg": ring_problem(S.PCG_CAMS, S.PCG_POINTS, S.PCG_TRACK, seed=3,
                            row_width=3)[0],
    }
    print(f"rings built in {time.perf_counter() - t0:.1f}s", file=sys.stderr,
          flush=True)
    result = {"card": smi, "reps": args.reps, "runs": []}
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/rings.pt"
        torch.save({k: p.tensors() for k, p in probs.items()}, path)
        for name, root in (("old", args.old.resolve()), ("new", REPO),
                           ("new", REPO), ("old", args.old.resolve())):
            r = solve_in(root, path, args.reps)
            result["runs"].append({"tree": name, **r})
            print(name, json.dumps({k: v["lm_iters_per_s"] for k, v in r.items()}),
                  file=sys.stderr, flush=True)
    result["sums"] = sums_alone(probs)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
