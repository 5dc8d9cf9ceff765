"""Benchmarks of the PyTorch/CUDA port's hot paths: bench.py's measurements.

    python3 bench_torch.py [--device cuda]
    BENCH_SMOKE=1 python3 bench_torch.py --device cpu     # tiny shapes

The counterpart of bench.py (which runs the JAX package): the same four
measurements at the same shapes, seeds, warm-ups and repetitions, through
the port on one device, and the same one JSON line on stdout:
  {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ..., "extra": {...}}

  * value (global_ba_lm_iters_per_sec) — dense-Schur LM iterations/s on the
                              128-camera / 40k-point / track-8 ring, 50
                              iterations (one warm-up solve, one timed).
  * global_ba_pcg_1024cam   — 1024 cams / 200k points / track 6 through the
                              PCG solver, 10 LM iterations of 50 CG steps;
                              est_gflops is bench.py's analytic estimate
                              (about 400 flops per observation for the
                              system build and 250 per CG step), not a
                              measured rate.
  * extraction_images_per_sec_1p2mp — `SIFT.extract_batch` on four
                              rendered 1280x960 images, 8024 features, 3
                              timed batches after a warm-up.
  * matching_pairs_per_sec_8192 — 64 single-pair calls of
                              `match_descriptors_pair_auto` (kernel 3, one
                              pair per launch, on a card) at capacity 8192,
                              cycling 8 descriptor banks, one wait at the
                              end.

vs_baseline is the speed-up over the same solver on the host CPU: the port
itself with --device cpu, run in a child process (dense 20 and PCG 3 LM
iterations, as bench.py's child runs them).  opencv_cpu is cv2.SIFT and
cv2.BFMatcher (knn 2, ratio, cross-check) on the host CPU where cv2
imports, else null with the reason on stderr.  Baselines are measured once
per checkout and cached in build/bench_torch_cpu_baseline.json; BENCH_SMOKE
skips them.  --device cuda (the default) raises when no GPU is visible.
Logs go to stderr, the first line the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
CACHE = REPO / "build" / "bench_torch_cpu_baseline.json"
CHILD_TIMEOUT_S = 1800

SMOKE = bool(os.environ.get("BENCH_SMOKE"))

CAMS = 128
POINTS = 40000
TRACK = 8
ITERS = 50

PCG_CAMS = 1024
PCG_POINTS = 200_000
PCG_TRACK = 6
PCG_LM_ITERS = 10
PCG_INNER = 50

EXTRACT_W, EXTRACT_H = 1280, 960
EXTRACT_FEATURES = 8024
K_PER_OCTAVE = 4096     # SIFT's candidate budget per octave (its default)
MATCH_CAP = 8192

if SMOKE:  # tiny shapes, so that a CPU test can run the script end to end
    CAMS, POINTS, TRACK, ITERS = 8, 1500, 4, 3
    PCG_CAMS, PCG_POINTS, PCG_TRACK, PCG_LM_ITERS, PCG_INNER = 16, 2000, 4, 2, 5
    EXTRACT_W, EXTRACT_H, EXTRACT_FEATURES = 320, 240, 512
    # The port's SIFT on the CPU costs time per candidate, not per pixel
    # (about a minute per image at 4096 candidates per octave).
    K_PER_OCTAVE = 256
    MATCH_CAP = 1024


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _sync(device):
    from monocularsfm_torch.utils.card import sync

    sync(device)


def _load_cache() -> dict:
    try:
        return json.loads(CACHE.read_text())
    except (OSError, ValueError):
        return {}


def _save_cache(data: dict):
    CACHE.parent.mkdir(parents=True, exist_ok=True)
    CACHE.write_text(json.dumps(data))


def _timed_ba(prob, device, **kw):
    """bench.py's solve twice, the second timed: (result, seconds)."""
    from monocularsfm_torch.optim import bundle_adjust

    bundle_adjust(prob, **kw)
    _sync(device)
    t0 = time.perf_counter()
    out = bundle_adjust(prob, **kw)
    _sync(device)
    return out, time.perf_counter() - t0


def measure_dense(device, iters=ITERS):
    """(LM iterations/s, rmse_final) of the dense solver."""
    from monocularsfm_torch.utils.ring_problem import ring_problem

    prob, nobs = ring_problem(CAMS, POINTS, TRACK)
    log(f"[dense] device={device}: {CAMS} cams, {POINTS} points, {nobs} obs")
    out, dt = _timed_ba(prob.to(device), device, max_iterations=iters)
    n_it = int(out["iterations"])
    rmse = float(out["rmse_final"])
    log(f"[dense] {n_it} LM iters in {dt:.3f}s -> {n_it/dt:.2f} iters/s | "
        f"rmse {float(out['rmse_initial']):.3f} -> {rmse:.4f}")
    return n_it / dt, rmse


def measure_pcg(device, iters=PCG_LM_ITERS):
    """(LM iterations/s, estimated GFLOP/s, observations, rmse_final) of the
    PCG solver."""
    from monocularsfm_torch.utils.ring_problem import ring_problem

    prob, nobs = ring_problem(PCG_CAMS, PCG_POINTS, PCG_TRACK, seed=3)
    log(f"[pcg] device={device}: {PCG_CAMS} cams, {PCG_POINTS} points, "
        f"{nobs} obs")
    out, dt = _timed_ba(prob.to(device), device, max_iterations=iters,
                        solve_mode="pcg", pcg_iters=PCG_INNER)
    n_it = int(out["iterations"])
    rmse = float(out["rmse_final"])
    # bench.py's analytic FLOP estimate per LM iteration (not measured): one
    # system build (~400 flops/obs) plus the full budget of CG matvecs
    # (~250 flops/obs each; the rtol early exit makes it an upper bound).
    flops_per_iter = nobs * (400 + 250 * PCG_INNER)
    gflops = flops_per_iter * n_it / dt / 1e9
    log(f"[pcg] {n_it} LM iters ({PCG_INNER} CG each, {out['cg_steps']} CG "
        f"steps run) in {dt:.3f}s -> {n_it/dt:.3f} iters/s (~{gflops:.0f} "
        f"GFLOP/s est) | rmse {float(out['rmse_initial']):.3f} -> {rmse:.4f}")
    return n_it / dt, gflops, nobs, rmse


def _bench_image(num=4):
    from monocularsfm_torch.utils.synthetic import render_textured_images

    imgs, _, _, _ = render_textured_images(
        scene_seed=5, num_cameras=num, width=EXTRACT_W, height=EXTRACT_H)
    return imgs


def measure_extraction(device):
    """Batched extraction images/s: the pipeline's batch of 4."""
    from monocularsfm_torch.ops.sift import SIFT

    imgs = _bench_image()
    batch = imgs if not SMOKE else imgs[:2]
    sift = SIFT(num_features=EXTRACT_FEATURES, k_per_octave=K_PER_OCTAVE,
                device=device)
    kps, _ = sift.extract_batch(batch)  # warm-up
    log(f"[extract] device={device} {EXTRACT_W}x{EXTRACT_H}: "
        f"{len(kps[0])} feats")
    _sync(device)
    reps, t0 = 3, time.perf_counter()
    for _ in range(reps):
        sift.extract_batch(batch)
    _sync(device)
    dt = time.perf_counter() - t0
    n = reps * len(batch)
    log(f"[extract] {n} images in {dt:.2f}s -> {n/dt:.3f} images/s")
    return n / dt


def measure_extraction_cv2():
    import cv2

    imgs = _bench_image()
    sift = cv2.SIFT_create(nfeatures=EXTRACT_FEATURES)
    sift.detectAndCompute(imgs[0], None)  # warm-up
    reps, t0 = 8, time.perf_counter()
    for r in range(reps):
        sift.detectAndCompute(imgs[r % len(imgs)], None)
    dt = time.perf_counter() - t0
    log(f"[extract-cv2] {reps} images in {dt:.2f}s -> {reps/dt:.3f} images/s")
    return reps / dt


def _match_bank(num=8):
    rng = np.random.default_rng(11)
    base = rng.standard_normal((MATCH_CAP, 128)).astype(np.float32)
    descs = []
    for _ in range(num):
        d = base + 0.35 * rng.standard_normal(base.shape).astype(np.float32)
        d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)
        descs.append(d)
    return descs


def measure_matching(device):
    """Single-pair matches/s: 64 calls, one wait at the end."""
    import torch

    from monocularsfm_torch.ops.matching import match_descriptors_pair_auto

    descs = [torch.from_numpy(d).to(device) for d in _match_bank()]
    mask = torch.ones(MATCH_CAP, dtype=torch.bool, device=device)
    out = match_descriptors_pair_auto(descs[0], descs[1], mask, mask)
    out.cpu()  # warm-up, waited for
    reps, t0 = 64, time.perf_counter()
    outs = [
        match_descriptors_pair_auto(
            descs[r % 8], descs[(r + 1) % 8], mask, mask)
        for r in range(reps)
    ]
    int(sum(o.sum() for o in outs))  # waits for every call
    dt = time.perf_counter() - t0
    log(f"[match] device={device} cap={MATCH_CAP}: {reps} pairs in "
        f"{dt:.2f}s -> {reps/dt:.2f} pairs/s")
    return reps / dt


def measure_matching_cv2():
    import cv2

    descs = _match_bank(4)
    bf = cv2.BFMatcher()
    t0 = time.perf_counter()
    reps = 4
    for r in range(reps):
        a, b = descs[r % 4], descs[(r + 1) % 4]
        mab = bf.knnMatch(a, b, k=2)
        mba = bf.knnMatch(b, a, k=2)
        fwd = {m[0].queryIdx: m[0].trainIdx for m in mab
               if len(m) == 2 and m[0].distance < 0.8 * m[1].distance}
        _ = [q for q, t_ in fwd.items()
             for m in [mba[t_]]
             if len(m) == 2 and m[0].distance < 0.8 * m[1].distance
             and m[0].trainIdx == q]
    dt = time.perf_counter() - t0
    log(f"[match-cv2] {reps} pairs in {dt:.2f}s -> {reps/dt:.3f} pairs/s")
    return reps / dt


def run_all(device="cuda"):
    """The four measurements on `device`: bench.py's result keys plus the
    two solves' rmse_final."""
    from monocularsfm_torch.reconstruction.map_builder import resolve_device

    dev = resolve_device(device)
    results = {}
    results["dense_ips"], results["dense_rmse"] = measure_dense(dev)
    (results["pcg_ips"], results["pcg_gflops"], results["pcg_obs"],
     results["pcg_rmse"]) = measure_pcg(dev)
    results["extract_ips"] = measure_extraction(dev)
    results["match_pps"] = measure_matching(dev)
    return results


def cpu_baselines(needed) -> dict:
    """Measure missing baselines on the host CPU, each in a child process
    with a timeout; cache them.  A baseline that cannot run is null."""
    cache = _load_cache()
    for key in [k for k in needed if k not in cache]:
        log(f"measuring cpu baseline {key} (subprocess)...")
        env = dict(os.environ, BENCH_CPU_CHILD=key)
        try:
            res = subprocess.run(
                [sys.executable, __file__, "--device", "cpu"], env=env,
                capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            log(f"cpu baseline {key}: null (the child passed "
                f"{CHILD_TIMEOUT_S} s)")
            continue
        sys.stderr.write(res.stderr[-2000:])
        if res.returncode != 0:
            log(f"cpu baseline {key}: null (the child exited {res.returncode})")
            continue
        cache.update(json.loads(res.stdout.strip().splitlines()[-1]))
        _save_cache(cache)
    for k in needed:
        log(f"cpu baseline {k}: {cache.get(k)}")
    return cache


def child_main(key: str):
    """One baseline on the host CPU, printed as {key: value}; the OpenCV
    ones null (with the reason on stderr) where cv2 does not import."""
    if key in ("extract_cv2", "match_cv2"):
        try:
            import cv2  # noqa: F401
        except ImportError as e:
            log(f"cpu baseline {key}: null, cv2 does not import here ({e})")
            print(json.dumps({key: None}))
            return
    value = {
        "dense": lambda: measure_dense("cpu", iters=20)[0],
        "pcg": lambda: measure_pcg("cpu", iters=3)[0],
        "extract_cv2": measure_extraction_cv2,
        "match_cv2": measure_matching_cv2,
    }[key]()
    print(json.dumps({key: value}))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    child = os.environ.get("BENCH_CPU_CHILD")
    if child:
        child_main(child)
        return
    from monocularsfm_torch.reconstruction.map_builder import resolve_device
    from monocularsfm_torch.utils.card import card_line

    dev = resolve_device(args.device)
    log(card_line(dev))
    r = run_all(dev)
    if SMOKE:
        base = {}
    else:
        base = cpu_baselines(["dense", "pcg", "extract_cv2", "match_cv2"])

    def ratio(v, b):
        return round(v / b, 3) if b else None

    extra = {
        "global_ba_pcg_1024cam": {
            "iters_per_sec": round(r["pcg_ips"], 4),
            "observations": r["pcg_obs"],
            "est_gflops": round(r["pcg_gflops"], 1),
            "cpu_iters_per_sec": base.get("pcg"),
            "vs_cpu": ratio(r["pcg_ips"], base.get("pcg")),
        },
        "extraction_images_per_sec_1p2mp": {
            "value": round(r["extract_ips"], 4),
            "opencv_cpu": base.get("extract_cv2"),
            "vs_opencv": ratio(r["extract_ips"], base.get("extract_cv2")),
        },
        "matching_pairs_per_sec_8192": {
            "value": round(r["match_pps"], 3),
            "opencv_cpu": base.get("match_cv2"),
            "vs_opencv": ratio(r["match_pps"], base.get("match_cv2")),
        },
    }
    print(json.dumps({
        "metric": "global_ba_lm_iters_per_sec",
        "value": round(r["dense_ips"], 3),
        "unit": "iters/s",
        "vs_baseline": ratio(r["dense_ips"], base.get("dense")),
        "extra": extra,
    }))


if __name__ == "__main__":
    main()
