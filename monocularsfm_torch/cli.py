"""The `sfm-torch` command-line interface.

    sfm-torch extract       <config.yaml> [--device cuda]   images -> features
    sfm-torch match         <config.yaml> [--device cuda]   features -> matches
    sfm-torch check-matches <config.yaml> [--render-dir D]  per-pair statistics
    sfm-torch reconstruct   <config.yaml> [--device cuda]   matches -> model + exports
    sfm-torch pipeline      <config.yaml> [--device cuda]   all of the above in order

The SQLite database is the only interface between stages, as in the JAX
package's `sfm` CLI, so a database written by one package's stage can be
read by the other's next stage.  A CUDA device without a visible GPU raises.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np


def cmd_extract(cfg, device="cuda", log=print):
    from monocularsfm_torch.features.extraction import FeatureExtractor

    t0 = time.perf_counter()
    n = FeatureExtractor(cfg.extraction, device=device).run_extraction(
        cfg.images_path, cfg.database_path, log=log
    )
    log(f"[extract] processed {n} images in {time.perf_counter()-t0:.1f}s")
    return n


def cmd_match(cfg, device="cuda", log=print):
    from monocularsfm_torch.features.matching import (
        BruteFeatureMatcher,
        SequentialFeatureMatcher,
        VocabTreeFeatureMatcher,
    )

    t0 = time.perf_counter()
    cls = {
        "sequential": SequentialFeatureMatcher,
        "vocab": VocabTreeFeatureMatcher,
    }.get(cfg.matching.match_type, BruteFeatureMatcher)
    n = cls(cfg.matching, device=device).run_matching(
        cfg.database_path, log=log)
    log(f"[match] wrote {n} pairs in {time.perf_counter()-t0:.1f}s")
    return n


def cmd_reconstruct(cfg, device="cuda", log=print, metrics_path=None):
    """Reconstruct from the database and export; returns the MapBuilder.
    With `metrics_path`, the build's JSON-lines event log goes there."""
    from monocularsfm_torch.database import Database
    from monocularsfm_torch.reconstruction import MapBuilder

    builder = MapBuilder(cfg, device=device)
    db = Database(cfg.database_path)
    try:
        names = db.read_all_images()
        keypoints = {}
        colors = {}
        for i in names:
            k = db.read_keypoints(i)
            if k is None:
                continue
            keypoints[i] = k
            c = db.read_keypoints_color(i)
            colors[i] = c if c is not None else np.zeros((len(k), 3), np.uint8)
        matches = {p: m for p, m in db.read_all_matches().items() if len(m)}
    finally:
        db.close()

    builder._log = log
    if metrics_path:
        builder.enable_metrics(metrics_path)
    try:
        builder.setup(matches, keypoints, colors=colors, names=names)
        summary = builder.do_build()
    finally:
        builder.close()
    log(str(summary))

    out = pathlib.Path(cfg.output_path or ".")
    out.mkdir(parents=True, exist_ok=True)
    cmd_export(cfg, builder.map, out, log=log)
    return builder


def cmd_export(cfg, map_obj, out_dir, log=print):
    from monocularsfm_torch.io import (
        write_colmap,
        write_openmvs,
        write_ply,
        write_ply_binary,
    )

    out = pathlib.Path(out_dir)
    write_colmap(map_obj, out / "colmap")
    write_ply(map_obj, out / "cloud.ply")
    write_ply_binary(map_obj, out / "cloud_binary.ply")
    write_openmvs(
        map_obj, out / "scene.mvs", image_dir=cfg.images_path,
        images_path=cfg.images_path, dist=cfg.camera.dist_coeffs(), log=log,
    )
    log(f"[export] COLMAP/PLY/OpenMVS written to {out}")


def cmd_check_matches(cfg, log=print, render_dir=None):
    """Per-pair match counts; with `render_dir`, side-by-side PNGs of the top
    20 pairs (the reference's ShowMatches, headless; needs OpenCV)."""
    from monocularsfm_torch.database import Database

    db = Database(cfg.database_path)
    try:
        names = db.read_all_images()
        matches = db.read_all_matches()
        log(f"images: {len(names)}  match pairs: {len(matches)}")
        counts = sorted(
            ((len(m), a, b) for (a, b), m in matches.items()), reverse=True
        )
        for cnt, a, b in counts[:50]:
            log(f"  {names.get(a, a)} -- {names.get(b, b)}: {cnt}")
        if render_dir:
            import cv2

            from monocularsfm_torch.utils.debug_draw import draw_matches

            out = pathlib.Path(render_dir)
            out.mkdir(parents=True, exist_ok=True)
            root = pathlib.Path(cfg.images_path)
            for cnt, a, b in counts[:20]:
                if cnt == 0:
                    continue
                m = matches[(a, b)]
                k1 = db.read_keypoints(a)
                k2 = db.read_keypoints(b)
                i1 = cv2.imread(str(root / names[a]))
                i2 = cv2.imread(str(root / names[b]))
                if i1 is None or i2 is None:
                    continue
                draw_matches(
                    i1, i2, k1[m[:, 0], :2], k2[m[:, 1], :2],
                    out / f"matches_{a}_{b}.png",
                )
        nonzero = [c for c, _, _ in counts if c > 0]
        if nonzero:
            log(
                f"mean matches/pair: {np.mean(nonzero):.1f}  "
                f"median: {np.median(nonzero):.0f}"
            )
    finally:
        db.close()
    return {(a, b): cnt for cnt, a, b in counts}


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="sfm-torch",
        description="Incremental Structure-from-Motion on PyTorch/CUDA",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    for name in ("extract", "match", "check-matches", "reconstruct", "pipeline"):
        p = sub.add_parser(name)
        p.add_argument("config", help="YAML config (reference-style or nested)")
        if name == "check-matches":
            p.add_argument(
                "--render-dir", default=None,
                help="write side-by-side match PNGs for the top pairs here",
            )
        else:
            p.add_argument("--device", default="cuda",
                           help="torch device of the stage (default: cuda)")
    args = parser.parse_args(argv)

    from monocularsfm_torch.config import load_yaml

    cfg = load_yaml(args.config)
    if args.command != "check-matches":
        from monocularsfm_torch.reconstruction.map_builder import resolve_device

        resolve_device(args.device)
    if args.command == "extract":
        cmd_extract(cfg, device=args.device)
    elif args.command == "match":
        cmd_match(cfg, device=args.device)
    elif args.command == "check-matches":
        cmd_check_matches(cfg, render_dir=args.render_dir)
    elif args.command == "reconstruct":
        cmd_reconstruct(cfg, device=args.device)
    elif args.command == "pipeline":
        cmd_extract(cfg, device=args.device)
        cmd_match(cfg, device=args.device)
        cmd_reconstruct(cfg, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
