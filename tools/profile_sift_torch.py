"""Per-stage time of the port's SIFT extraction, per sampling mode.

The PyTorch counterpart of tools/profile_sift.py.  For each of `--modes`
(SIFT's `sample_mode`: "gather" and "patch" by default, as in the JAX
tool) it runs the stages of `SIFT.extract_batch` one at a time on a batch
of rendered views: the base image (2x upsample and base blur), then per
octave the Gaussian stack (`_build_octave_batched`), detection
(`_detect_octave`, with its exact top-k sort timed apart) and orientation
with descriptors (`_orient_and_describe` in the mode's sampler, and
`_collect_octave`), and last the cross-octave selection
(`_select_top_features`).  On the card each stage
is timed by CUDA events and waited for before the next starts; on the CPU
by the host clock.  On the card one more pass runs each stage under
torch.profiler, for its kernel launches and the card's busy time, so the
stage's idle share is 1 - busy / time.

Usage: python tools/profile_sift_torch.py [--width 1280 --height 960
       --batch 4] [--reps 2] [--modes gather,patch] [--device cuda]
       python tools/profile_sift_torch.py --width 3200 --height 2400 --batch 1

Prints one line per stage of each mode and, last, one JSON object of every
number, each mode's under "modes".
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


class StageClock:
    """Times stages by CUDA events (card) or the host clock (CPU), waiting
    for the card after each.  `top_k` wraps the SIFT module's sort so that
    its time is charged to the stage that called it."""

    def __init__(self, dev, profiled=False):
        import torch

        self.torch = torch
        self.dev = dev
        self.cuda = dev.type == "cuda"
        self.profiled = profiled and self.cuda
        self.ms, self.top_k_ms, self.launches, self.busy_ms = {}, {}, {}, {}
        self._stage = None

    def _mark(self):
        if self.cuda:
            e = self.torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def _elapsed(self, a, b):
        if self.cuda:
            b.synchronize()
            return a.elapsed_time(b)
        return 1e3 * (b - a)

    def run(self, name, fn, *args):
        from torch.profiler import ProfilerActivity, profile

        from monocularsfm_torch.utils.card import sync

        self._stage = name
        sync(self.dev)
        if self.profiled:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = fn(*args)
                sync(self.dev)
            kernels = [e for e in prof.events()
                       if e.device_type == self.torch.autograd.DeviceType.CUDA]
            self.launches[name] = len(kernels)
            self.busy_ms[name] = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        else:
            a = self._mark()
            out = fn(*args)
            self.ms[name] = self._elapsed(a, self._mark())
        self._stage = None
        return out

    def top_k(self, sort):
        def timed(x, k):
            a = self._mark()
            out = sort(x, k)
            if not self.profiled:
                self.top_k_ms[self._stage] = (self.top_k_ms.get(self._stage, 0.0)
                                              + self._elapsed(a, self._mark()))
            return out
        return timed


def run_stages(ex, imgs_t, clock):
    """The stages of `_extract_all` in its order; returns the number of
    selected keypoints per image (to hold against extract_batch)."""
    import torch

    from monocularsfm_torch.ops import sift as S
    from monocularsfm_torch.ops.blur import blur_multi

    H0, W0 = (2 * imgs_t.shape[1], 2 * imgs_t.shape[2])
    num_octaves, k_sched = ex._schedule(H0, W0)
    sigma_diff = math.sqrt(max(S.SIGMA0 ** 2 - 4.0 * S.INIT_SIGMA ** 2, 0.01))
    kb = torch.as_tensor(S.gaussian_kernel1d(sigma_diff))[None, :]

    def base():
        return blur_multi(S._upsample2x(imgs_t).contiguous(), kb)[:, 0]

    g = clock.run("base", base)
    kps, descs, valids = [], [], []
    for o in range(num_octaves):
        if o:
            g = clock.run(f"oct{o}.next_base",
                          lambda: gauss[:, S.N_SCALES, ::2, ::2].contiguous())
        gauss = clock.run(f"oct{o}.pyr", S._build_octave_batched, g)
        det = clock.run(f"oct{o}.detect", S._detect_octave, gauss, k_sched[o],
                        ex.contrast_threshold)

        def orient(gauss=gauss, det=det, o=o):
            angles, avalid, desc = S._orient_and_describe(gauss, det,
                                                          ex.sample_mode)
            return S._collect_octave(det, angles, avalid, desc, 2.0 ** (o - 1))

        kp, desc, val = clock.run(f"oct{o}.orient_desc", orient)
        kps.append(kp)
        descs.append(desc)
        valids.append(val)
    _, _, val_s = clock.run(
        "select", S._select_top_features, torch.cat(kps, 1), torch.cat(descs, 1),
        torch.cat(valids, 1), ex.num_features, ex.normalization, ex.transfer_dtype)
    return val_s.sum(1).tolist(), list(k_sched)


def profile_mode(ex, imgs, imgs_t, reps_n, dev):
    """One sampling mode: the first extract_batch (which builds the kernels
    and gives the reference counts), `reps_n` timed passes of the stages
    and, on the card, one profiled pass.  Prints the stage lines and
    returns the mode's numbers."""
    import torch

    from monocularsfm_torch.ops import sift as S
    from monocularsfm_torch.utils.card import sync

    mode = ex.sample_mode
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sync(dev)
    t0 = time.perf_counter()
    kps, _ = ex.extract_batch(imgs)
    wall = time.perf_counter() - t0
    print(f"[{mode}] extract_batch (first call): {wall:.3f}s  "
          f"feats={[len(k) for k in kps]}", flush=True)
    sort = S._top_k
    reps = []
    launches, busy = {}, {}
    try:
        with torch.no_grad():
            for r in range(reps_n + (dev.type == "cuda")):
                profiled = r == reps_n              # the last pass, on the card
                clock = StageClock(dev, profiled=profiled)
                S._top_k = clock.top_k(sort)
                counts, k_sched = run_stages(ex, imgs_t, clock)
                if counts != [len(k) for k in kps]:
                    raise RuntimeError(f"[{mode}] stages selected {counts} "
                                       f"keypoints, extract_batch "
                                       f"{[len(k) for k in kps]}")
                if profiled:
                    launches, busy = clock.launches, clock.busy_ms
                else:
                    reps.append((clock.ms, clock.top_k_ms))
    finally:
        S._top_k = sort
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None

    # Median over the timed reps, per stage.
    names = list(reps[0][0])
    ms = {n: float(np.median([r[0][n] for r in reps])) for n in names}
    top_k_ms = {n: float(np.median([r[1].get(n, 0.0) for r in reps]))
                for n in names if n in reps[0][1]}
    print(f"--- {mode}: median of {len(reps)} reps (ms) ---", flush=True)
    for n in names:
        extra = f"  top_k {top_k_ms[n]:8.2f}" if n in top_k_ms else ""
        if n in launches:
            extra += (f"  launches {launches[n]:6d}  busy {busy[n]:8.2f}  idle "
                      f"{1 - busy[n] / ms[n]:.3f}")
        print(f"{n:18s} {ms[n]:9.2f}{extra}", flush=True)
    total = sum(ms.values())
    groups = {g: sum(v for n, v in ms.items() if n.split(".")[-1] == g)
              for g in ("base", "pyr", "next_base", "detect", "orient_desc", "select")}
    print(f"SUM [{mode}]: " + "  ".join(f"{g} {v:.2f}" for g, v in groups.items())
          + f"  total {total:.2f} ms", flush=True)
    return k_sched, {
        "first_extract_batch_s": wall, "keypoints": [len(k) for k in kps],
        "stages_ms": ms, "top_k_ms": top_k_ms, "groups_ms": groups,
        "total_ms": total, "launches": launches, "busy_ms": busy,
        "launches_total": sum(launches.values()) if launches else None,
        "idle_share": (1 - sum(busy.values()) / total) if busy else None,
        "peak_memory_bytes": peak,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=960)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--modes", default="gather,patch")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from monocularsfm_torch.ops import sift as S
    from monocularsfm_torch.reconstruction.map_builder import resolve_device
    from monocularsfm_torch.utils.card import card_line
    from monocularsfm_torch.utils.synthetic import render_textured_images

    dev = resolve_device(args.device)
    card = card_line(dev)
    imgs, _, _, _ = render_textured_images(
        scene_seed=5, num_cameras=args.batch, width=args.width, height=args.height)
    print(f"device={dev.type} card={card} imgs={imgs.shape}", flush=True)
    imgs_t = torch.from_numpy(np.asarray(imgs)).to(dev).float() / 255.0
    modes = {}
    for mode in args.modes.split(","):
        k_sched, modes[mode] = profile_mode(
            S.SIFT(sample_mode=mode, device=dev), imgs, imgs_t, args.reps, dev)
    print(json.dumps({
        "image": f"{args.width}x{args.height}", "batch": args.batch,
        "device": dev.type, "card": card, "k_sched": k_sched, "modes": modes,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
