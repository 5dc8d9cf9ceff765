"""Where a PnP RANSAC round's time goes on one card, and how good each
device's minimal-solver hypotheses are.

    python3 tools/pnp_profile.py [--out FILE]

On chip_smoke.py's PnP inputs (camera 2 of the seeded ring, 30% outliers,
4096 hypotheses x 8192 points):

1. each method's `estimate_pnp_ransac` under torch.profiler: the wall of
   one round, the device time summed over kernels, and the eight ops with
   the most device time; then the batched small-matrix solvers alone
   (CUDA events): eigh of 4096 12x12 and SVD of 4096 / 16384 3x3;
2. the UPnP and P6P hypotheses of the same 6-point samples on the card, on
   the CPU (both float32) and in float64 on the CPU: quantiles of the
   focal's relative error (UPnP) and of each pose's distance from the
   float64 pose of the same sign (P6P), against float64.

Prints (and writes to FILE, default chiprun_out/pnp_profile.json) one JSON
object.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def _device_ms(evt) -> float:
    t = getattr(evt, "device_time_total", None)
    if t is None:
        t = evt.cuda_time_total
    return t / 1e3


def profile_methods(dev, u, K, card):
    from torch.profiler import ProfilerActivity, profile

    from monocularsfm_torch.estimators.pnp import estimate_pnp_ransac

    out = {}
    for method in ("p3p", "epnp", "p6p", "upnp"):
        estimate_pnp_ransac(u, K, *card, method=method)          # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            estimate_pnp_ransac(u, K, *card, method=method)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        ev = [e for e in prof.key_averages() if _device_ms(e) > 0]
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        ev.sort(key=lambda e: -_device_ms(e))
        out[method] = {
            "wall_ms_profiled": wall, "kernel_ms": busy, "kernels": len(kernels),
            "top_ops_device_ms": {e.key: _device_ms(e) for e in ev[:8]}}
        print(f"[pnp_profile] {method}: wall {wall:.1f} ms, kernels {busy:.1f} ms "
              f"in {len(kernels)} launches; top "
              + ", ".join(f"{e.key} {_device_ms(e):.1f}" for e in ev[:5]),
              file=sys.stderr)
    return out


def time_solvers(dev):
    import chip_smoke

    g = torch.Generator(dev).manual_seed(0)
    A = torch.randn((4096, 12, 12), generator=g, device=dev)
    A = A @ A.transpose(-1, -2)
    B = torch.randn((16384, 3, 3), generator=g, device=dev)
    return {
        "eigh_4096x12x12_ms": chip_smoke.time_ms(lambda: torch.linalg.eigh(A), 5),
        "svd_4096x3x3_ms": chip_smoke.time_ms(lambda: torch.linalg.svd(B[:4096]), 5),
        "svd_16384x3x3_ms": chip_smoke.time_ms(lambda: torch.linalg.svd(B), 5),
    }


def hypothesis_quality(dev, u, K, host):
    from monocularsfm_torch.estimators import pnp
    from monocularsfm_torch.estimators.ransac import sample_minimal_sets

    X, uv, mask = host
    sets = sample_minimal_sets(u, 6, mask)
    uvc = uv - K[:2, 2]
    xn = uvc / K[[0, 1], [0, 1]]
    Xs = X[sets]
    f64 = pnp._fit_upnp6(Xs.double(), uvc[sets].double())[2]
    R64, t64 = pnp._fit_p6p(Xs.double(), xn[sets].double())
    P64 = pnp._dlt_null_vector(Xs.double(), xn[sets].double())
    Rn, sc = pnp._project_so3(-P64[..., :3])
    tn = -P64[..., 3] / sc[..., None]
    q = (0.5, 0.9)
    out = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        f = pnp._fit_upnp6(Xs.to(d), uvc[sets].to(d))[2].cpu().double()
        R, t = (a.cpu().double() for a in pnp._fit_p6p(Xs.to(d), xn[sets].to(d)))
        err = torch.minimum(
            torch.maximum((R - R64).abs().amax((-1, -2)), (t - t64).abs().amax(-1)),
            torch.maximum((R - Rn).abs().amax((-1, -2)), (t - tn).abs().amax(-1)))
        rel = (f / f64 - 1.0).abs()
        out[name] = {
            "upnp_focal_rel_err_quantiles": np.quantile(rel.numpy(), q).tolist(),
            "upnp_focal_within_1pct": (rel <= 0.01).double().mean().item(),
            "p6p_pose_err_quantiles": np.quantile(err.numpy(), q).tolist(),
            "p6p_within_1e-3": (err <= 1e-3).double().mean().item()}
        print(f"[pnp_profile] hypotheses on {name}: {out[name]}", file=sys.stderr)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=pathlib.Path,
                    default=REPO / "chiprun_out" / "pnp_profile.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU (torch.cuda.is_available() is false)")
    import chip_smoke
    import monocularsfm_torch  # noqa: F401  (precision pins)

    dev = torch.device("cuda")
    scene, u, host, card = chip_smoke.pnp_inputs(dev)
    K = torch.from_numpy(scene.K.astype(np.float32))
    res = {"device": torch.cuda.get_device_name(0),
           "methods": profile_methods(dev, u.to(dev), K.to(dev), card),
           "solvers": time_solvers(dev),
           "hypotheses": hypothesis_quality(dev, u, K, host)}
    text = json.dumps(res)
    print(text)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(text)


if __name__ == "__main__":
    main()
