"""The port's whole pipeline at its users' scale, checked against the truth.

The PyTorch counterpart of tools/scale_run.py.  Renders the multi-plane
collection (128 views of 1280x960 on a 200-degree arc: the reference's
south-building scale), runs `sfm-torch` extract -> match -> reconstruct ->
export on `--device` with a wall per phase (the card's queue drained at
each boundary), reads the solver of every global bundle adjustment from
the build's event log (dense Schur for small bundles; PCG on split track
rows beyond `dense_max_images` views or the dense path's observation
capacity `dense_max_obs`), and evaluates the cameras against the exact
poses.

Gates (a failed one exits 1): at least all views but one registered, mean
reprojection error below 0.5 px, camera-centre RMS after similarity
alignment below 0.1% of the scene diagonal, and at least one PCG global BA
when the view count exceeds `dense_max_images`.

Usage:
  python tools/scale_run_torch.py                        # 128 views, GPU
  python tools/scale_run_torch.py --render-only          # render once
  python tools/scale_run_torch.py --stage reconstruct    # one stage
  python tools/scale_run_torch.py --device cpu --data build/scale_data/mp6 \\
      --num-images 6 --width 320 --height 240 --arc-deg 20

The dataset is rendered once per `--data` directory (PNGs and gt.npz) and
reused; each label gets its own database, output and event log.  The
result goes to <data>/result_<label>.json and, as one JSON object, to the
last line of standard output.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

REPROJ_MAX_PX = 0.5
CENTER_PCT_MAX = 0.1


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def render_dataset(data_dir: pathlib.Path, num_images: int, width: int,
                   height: int, seed: int, arc_deg: float = 200.0):
    """Render the views into <data>/images and their poses into gt.npz,
    unless a dataset of `num_images` views is already there."""
    from monocularsfm_torch.utils.png import write_png

    img_dir = data_dir / "images"
    gt_path = data_dir / "gt.npz"
    if gt_path.exists() and len(list(img_dir.glob("*.png"))) >= num_images:
        with np.load(gt_path) as gt:
            if len(gt["R"]) == num_images:
                log(f"[render] dataset already present at {data_dir}")
                return
    from monocularsfm_torch.utils.synthetic import render_multiplane_images

    img_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    images, K, R, t = render_multiplane_images(
        scene_seed=seed, num_cameras=num_images, width=width, height=height,
        arc_deg=arc_deg)
    for i in range(num_images):
        write_png(img_dir / f"frame{i:04d}.png", images[i])
    np.savez(gt_path, K=K, R=R, t=t)
    log(f"[render] {num_images} images {width}x{height} in "
        f"{time.perf_counter() - t0:.1f}s -> {img_dir}")


def build_config(data_dir: pathlib.Path, label: str, backend: str,
                 overlap: int, num_features: int,
                 match_backend: str = "auto", match_type: str = "sequential"):
    """tools/scale_run.py's configuration, built in code."""
    from monocularsfm_torch.config import SfMConfig

    with np.load(data_dir / "gt.npz") as gt:
        K = gt["K"]
    cfg = SfMConfig()
    cfg.images_path = str(data_dir / "images")
    cfg.database_path = str(data_dir / f"db_{label}.sqlite")
    cfg.output_path = str(data_dir / f"out_{label}")
    cfg.camera.fx, cfg.camera.fy = float(K[0, 0]), float(K[1, 1])
    cfg.camera.cx, cfg.camera.cy = float(K[0, 2]), float(K[1, 2])
    cfg.extraction.backend = backend
    cfg.extraction.num_features = num_features
    cfg.extraction.max_image_size = 3200
    cfg.matching.match_type = match_type
    cfg.matching.overlap = overlap
    cfg.matching.backend = backend if match_backend == "auto" else match_backend
    return cfg


def global_ba_solvers(events_path: pathlib.Path) -> dict:
    """Dense and PCG global-BA counts and the largest PCG bundle, from the
    build's JSON-lines event log."""
    with open(events_path) as f:
        gba = [e for e in map(json.loads, f) if e["event"] == "global_ba"]
    pcg = [e for e in gba if e["solver"] == "pcg"]
    largest = max(pcg, key=lambda e: e["cams"], default=None)
    return {
        "dense": sum(e["solver"] == "dense" for e in gba),
        "pcg": len(pcg),
        "largest_pcg": (None if largest is None else
                        {k: largest[k] for k in ("cams", "iters", "rmse")}),
        "cams_by_solver": [(e["cams"], e["solver"]) for e in gba],
    }


def camera_centres(builder, gt, num_images: int):
    """(estimated, true) centres of the registered views."""
    names_to_id = {builder.map.images[i].name: i
                   for i in builder.map.registered_ids}
    src, dst = [], []
    for idx in range(num_images):
        i = names_to_id.get(f"frame{idx:04d}.png")
        if i is None:
            continue
        im = builder.map.images[i]
        src.append(-im.R.T @ im.t)
        dst.append(-gt["R"][idx].T @ gt["t"][idx])
    return np.asarray(src), np.asarray(dst)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", default=str(REPO / "build" / "scale_data" / "mp128"))
    ap.add_argument("--label", default=None,
                    help="names the database, output and result (default: "
                    "the device type)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="jax", choices=["jax", "opencv"],
                    help="extraction: jax = the port's device path; opencv "
                    "= cv2 on the host (CPU machines with OpenCV only)")
    ap.add_argument("--match-backend", default="auto",
                    choices=["auto", "jax", "opencv"])
    ap.add_argument("--match-type", default="sequential",
                    choices=["sequential", "brute", "vocab"])
    ap.add_argument("--num-images", type=int, default=128)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=960)
    ap.add_argument("--overlap", type=int, default=12)
    ap.add_argument("--num-features", type=int, default=8024)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--arc-deg", type=float, default=200.0,
                    help="camera arc span; 200/128 images ~ 1.6 deg steps, "
                    "a small-image run should scale the arc down too")
    ap.add_argument("--no-decay-octave", action="store_true",
                    help="disable the per-octave candidate budget decay")
    ap.add_argument("--render-only", action="store_true")
    ap.add_argument("--stage", default="all",
                    choices=["all", "extract", "match", "reconstruct"])
    args = ap.parse_args(argv)

    data_dir = pathlib.Path(args.data)
    if args.render_only:
        render_dataset(data_dir, args.num_images, args.width, args.height,
                       args.seed, args.arc_deg)
        return 0

    import torch

    from monocularsfm_torch import cli
    from monocularsfm_torch.ops import blur, match_kernel
    from monocularsfm_torch.reconstruction.map_builder import resolve_device
    from monocularsfm_torch.utils.card import card_line, sync

    dev = resolve_device(args.device)          # before the render: no card, no wait
    render_dataset(data_dir, args.num_images, args.width, args.height,
                   args.seed, args.arc_deg)
    label = args.label or dev.type
    card = card_line(dev)
    log(f"[device] {card} | torch {torch.__version__}")
    cfg = build_config(data_dir, label, args.backend, args.overlap,
                       args.num_features, args.match_backend, args.match_type)
    if args.no_decay_octave:
        cfg.extraction.decay_octave_budget = False
    events = data_dir / f"events_{label}.jsonl"
    events.unlink(missing_ok=True)
    phases = {}

    def timed(name, fn, *a, **kw):
        sync(dev)
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        sync(dev)
        phases[name] = time.perf_counter() - t0
        log(f"[phase] {name}: {phases[name]:.1f}s")
        return out

    blur.reset_launches()
    match_kernel.reset_launches()
    builder = None
    if args.stage in ("all", "extract"):
        timed("extract", cli.cmd_extract, cfg, device=dev, log=log)
    if args.stage in ("all", "match"):
        timed("match", cli.cmd_match, cfg, device=dev, log=log)
    if args.stage in ("all", "reconstruct"):
        builder = timed("reconstruct", cli.cmd_reconstruct, cfg, device=dev,
                        log=log, metrics_path=str(events))

    result = {
        "label": label,
        "backend": dev.type,
        "card": card,
        "extract_backend": args.backend,
        "num_images": args.num_images,
        "width": args.width,
        "height": args.height,
        "phases_s": phases,
        "total_s": sum(phases.values()),
        "launches": dict(blur.LAUNCHES, **match_kernel.LAUNCHES),
    }
    failed = []
    if builder is not None:
        st = builder.map.statistics()
        timers = {k: t.elapsed for k, t in builder.timers.items()}
        solvers = global_ba_solvers(events)
        result.update(
            registered=st.num_registered_images,
            points3D=st.num_points3D,
            observations=st.num_observations,
            mean_reproj_px=st.mean_reprojection_error,
            mean_track_length=st.mean_track_length,
            build_timers=timers,
            reconstruct_outside_mapbuilder_s=phases["reconstruct"] - timers["total"],
            global_ba=solvers,
        )
        with np.load(data_dir / "gt.npz") as gt:
            src, dst = camera_centres(builder, gt, args.num_images)
        center_pct = None
        if len(src) >= 3:
            from monocularsfm_torch.utils.synthetic import similarity_align

            _, rms = similarity_align(src, dst)
            diag = float(np.linalg.norm(np.ptp(dst, axis=0)))
            center_pct = 100 * rms / max(diag, 1e-9)
            result["camera_center_rms"] = rms
            result["camera_center_rms_pct_of_scene"] = center_pct
        need_pcg = args.num_images > cfg.bundle.dense_max_images
        gates = {
            "registered": st.num_registered_images >= args.num_images - 1,
            "mean_reproj_px": st.mean_reprojection_error < REPROJ_MAX_PX,
            "center_rms_pct": center_pct is not None and center_pct < CENTER_PCT_MAX,
            "pcg_global_ba": solvers["pcg"] >= 1 or not need_pcg,
        }
        result["gates"] = gates
        failed = [k for k, ok in gates.items() if not ok]

    out_path = data_dir / f"result_{label}.json"
    out_path.write_text(json.dumps(result, indent=2))
    log(f"[done] results -> {out_path}")
    if failed:
        log(f"[gates] FAILED: {failed}")
    print(json.dumps(result), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
