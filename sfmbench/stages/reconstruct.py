"""Whole reconstructions: the MapBuilder on a collection, as `sfm-torch
reconstruct` runs it, less the OpenMVS export.

Set-up renders the collection on the device (`lib/render.py`: the
configuration's views of a textured multi-plane scene, through its lens),
extracts features with the program's SIFT and matches them with its
sequential matcher into a SQLite database, as `sfm-torch extract` and
`match` would.  The collection is the same on every run.

One unit is what `cli.cmd_reconstruct` does but `write_openmvs`: read the
database, `MapBuilder.setup` and `do_build` on the device, write the COLMAP
model, `cloud.ply` and `cloud_binary.ply`, and take the registered poses
off the map (which lives on the host in float64).  The warm-up is one such
build on the same database, its keypoints moved by Gaussian noise that the
run's seed draws, so the check also sees data that differs from run to run.

The check holds the window's last model and the warm-up's against the
render's truth and against plain float64 geometry (`reference/`): the share
of views left unregistered (every view has to register), and the cost
decrease one exact Gauss-Newton step of the points alone, or of the cameras
alone, would still give on the model's own tracks, with the keypoints
undistorted again by the reference.  The camera centres' RMS against the
truth after a similarity alignment, over the extent of the views, is logged
and not judged: dropping the lens moves it by less than three times the
spread of sound runs.
"""

from __future__ import annotations

import pathlib
import shutil
import tempfile
import time

import numpy as np
import torch

from sfmbench.lib.common import State, camera_of, program_settings


def _quiet(*_args):
    pass


def sfm_config(settings: dict, out_dir: str, database: str):
    """The program's SfMConfig: its defaults, with every group of
    `settings` laid over them (an unknown key raises)."""
    from monocularsfm_torch.config import SfMConfig

    cfg = SfMConfig(database_path=database, output_path=out_dir)
    for group, values in settings.items():
        obj = getattr(cfg, group)
        for k, v in values.items():
            if not hasattr(obj, k):
                raise KeyError(f"the program has no setting {group}.{k}")
            setattr(obj, k, v)
    return cfg


def _collection(state: State, cfg, cam: dict) -> None:
    """Render the views on the device, extract and match them into the
    database at `cfg.database_path`."""
    from monocularsfm_torch.database import Database
    from monocularsfm_torch.features.extraction import FeatureExtractor
    from monocularsfm_torch.features.matching import SequentialFeatureMatcher
    from sfmbench.lib import render

    parts, device = state.info["setup_parts"], state.device
    n = state.config["views"]
    t0 = time.perf_counter()
    frames, R, t = render.render(state.config["scene"], cam, n, device)
    frames = frames.cpu().numpy()
    parts["render_s"] = time.perf_counter() - t0
    state.truth.update(R=R, t=t)

    t0 = time.perf_counter()
    extractor = FeatureExtractor(cfg.extraction, device=device)
    if "k_per_octave" in state.params:
        # The CPU tests' small candidate budget; the cells keep SIFT's own.
        extractor._get_sift().k_per_octave = state.params["k_per_octave"]
    db = Database(cfg.database_path)
    try:
        for i, gray in enumerate(frames):
            kps, colors, desc = extractor.extract_one(
                gray, np.repeat(gray[..., None], 3, axis=2))
            db.begin_transaction()
            image_id = db.write_image(f"view{i:03d}.png")
            db.write_keypoints(image_id, kps)
            db.write_keypoints_color(image_id, colors)
            db.write_descriptors(image_id, desc)
            db.end_transaction()
    finally:
        db.close()
    parts["extract_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pairs = SequentialFeatureMatcher(cfg.matching, device=device).run_matching(
        cfg.database_path, log=_quiet)
    parts["match_s"] = time.perf_counter() - t0
    state.info["pairs"] = pairs


def _read_database(path: str):
    """(names, keypoints, colors, matches) as `cli.cmd_reconstruct` reads
    them."""
    from monocularsfm_torch.database import Database

    db = Database(path)
    try:
        names = db.read_all_images()
        keypoints, colors = {}, {}
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
    return names, keypoints, colors, matches


def _view(name: str) -> int:
    """The view index in an image name `view<index>.png`."""
    return int(name[4:-4])


def build(state: State, first_views: int | None = None,
          noise=None) -> tuple[dict, dict, dict]:
    """One reconstruction from the database.  With `first_views`, only the
    collection's first views and their matches are built; with `noise`
    (sigma in px, a numpy Generator), every keypoint is moved by Gaussian
    noise first.  Returns (the unit's record, the model, the keypoints
    built from)."""
    from monocularsfm_torch.io import write_colmap, write_ply, write_ply_binary
    from monocularsfm_torch.reconstruction import MapBuilder

    cfg, device = state.program["cfg"], state.device
    t0 = time.perf_counter()
    names, keypoints, colors, matches = _read_database(cfg.database_path)
    if first_views is not None:
        names = {i: n for i, n in names.items() if _view(n) < first_views}
        keypoints = {i: keypoints[i] for i in names}
        colors = {i: colors[i] for i in names}
        matches = {p: m for p, m in matches.items() if set(p) <= set(names)}
    if noise is not None:
        sigma, rng = noise
        keypoints = {i: _moved(keypoints[i], sigma, rng) for i in sorted(keypoints)}
    builder = MapBuilder(cfg, device=device)
    builder._log = _quiet
    try:
        builder.setup(matches, keypoints, colors=colors, names=names)
        summary = builder.do_build()
    finally:
        builder.close()
    out = state.program["out"]
    write_colmap(builder.map, out / "colmap")
    write_ply(builder.map, out / "cloud.ply")
    write_ply_binary(builder.map, out / "cloud_binary.ply")
    poses = {i: (builder.map.images[i].R.copy(), builder.map.images[i].t.copy())
             for i in sorted(builder.map.registered_ids)}
    record = {"wall_s": time.perf_counter() - t0,
              "registered": summary.num_registered,
              "points": summary.num_points3D,
              "observations": summary.num_observations,
              "timers_s": {k: round(v, 4) for k, v in summary.timers.items()}}
    return record, dict(map=builder.map, poses=poses, names=names), keypoints


def _moved(k: np.ndarray, sigma: float, rng) -> np.ndarray:
    k = k.copy()
    k[:, :2] += rng.normal(0.0, sigma, (len(k), 2)).astype(k.dtype)
    return k


def setup(state: State) -> State:
    t0 = time.perf_counter()
    cam = camera_of(state.config)
    work = pathlib.Path(tempfile.mkdtemp(prefix="sfmbench-reconstruct-"))
    state.program["work"] = work
    state.program["out"] = work / "out"
    cfg = sfm_config(program_settings(state), str(work / "out"),
                     str(work / "collection.db"))
    state.program["cfg"] = cfg
    _collection(state, cfg, cam)
    state.info["setup_parts"]["collection_s"] = time.perf_counter() - t0
    state.log(f"[reconstruct] {state.config['views']} views of "
              f"{cam['width']}x{cam['height']}, {state.info['pairs']} pairs "
              f"matched")
    return state


def warm_up(state: State) -> None:
    """One build of the collection's first `warm_up_views` views with their
    keypoints moved by the seed's noise: the window's path, the program's
    first-use costs paid, on data that differs from run to run."""
    rng = np.random.default_rng(np.random.SeedSequence(
        [int(state.seed) % 2 ** 63, int(state.config["scene"]["scene_seed"])]))
    record, model, keypoints = build(
        state, first_views=state.params["warm_up_views"],
        noise=(state.params["warm_up_noise_px"], rng))
    state.truth["seeded"] = dict(model, keypoints=keypoints, record=record)
    state.log(f"[reconstruct] warm-up build: {record}")


def unit(state: State) -> dict:
    record, model, keypoints = build(state)
    state.program["result"] = dict(model, keypoints=keypoints)
    return record


def end_to_end(records, window_s) -> dict:
    return {"reconstruct_s": window_s / len(records)}


def _readings(state: State, model: dict, keypoints: dict) -> dict:
    """registered_miss, pose_miss and bundle_gain of one model."""
    from sfmbench.reference import geometry
    from sfmbench.reference.lens import undistort_pixels

    cam = camera_of(state.config)
    view = {i: _view(name) for i, name in model["names"].items()}
    reg = sorted(model["poses"])
    out = {"registered_miss": (len(view) - len(reg)) / len(view)}
    if len(reg) < 3:
        return dict(out, pose_miss=float("inf"), bundle_gain=float("inf"))
    R = np.stack([model["poses"][i][0] for i in reg]).astype(np.float64)
    t = np.stack([model["poses"][i][1] for i in reg]).astype(np.float64)
    C_truth = geometry.centres(state.truth["R"], state.truth["t"])
    C_true = C_truth[[view[i] for i in reg]]
    C = geometry.centres(R, t)
    s, Rs, ts = geometry.umeyama(C, C_true)
    err = s * C @ Rs.T + ts - C_true
    extent = float(np.linalg.norm(np.ptp(C_truth[sorted(view.values())], axis=0)))
    out["pose_miss"] = float(np.sqrt((err ** 2).sum(1).mean())) / extent

    m = model["map"]
    row = {i: r for r, i in enumerate(reg)}
    pids = m.point_ids()
    X = np.stack([m.xyz(int(p)) for p in pids]) if len(pids) else np.zeros((0, 3))
    cam_idx, pt_idx, kp = [], [], []
    for j, p in enumerate(pids):
        for i, k in m.track(int(p)):
            cam_idx.append(row[i])
            pt_idx.append(j)
            kp.append(keypoints[i][k, :2])
    if not kp:
        return dict(out, bundle_gain=float("inf"))
    uv = undistort_pixels(np.asarray(kp, np.float64), cam)
    dev = state.device
    K = np.array([cam["fx"], cam["fy"], cam["cx"], cam["cy"]])
    g = geometry.bundle_gain(
        K, torch.as_tensor(R, device=dev), torch.as_tensor(t, device=dev),
        torch.as_tensor(X, device=dev), torch.as_tensor(cam_idx, device=dev),
        torch.as_tensor(pt_idx, device=dev), uv.to(dev))
    out["bundle_gain"] = g["point_gain"] + g["camera_gain"]
    out["reprojection_px"] = g["mean_reproj_px"]
    out["points"], out["observations"] = len(pids), len(kp)
    return out


def check(state: State, records, log) -> list:
    model = state.program.pop("result")
    shutil.rmtree(state.program.pop("work"), ignore_errors=True)
    state.program.clear()
    window = _readings(state, model, model["keypoints"])
    seeded = state.truth["seeded"]
    warm = _readings(state, seeded, seeded["keypoints"])
    log(f"[reconstruct] builds {len(records)}, walls "
        f"{[round(r['wall_s'], 3) for r in records]} s, registered "
        f"{sorted({r['registered'] for r in records})}, points "
        f"{sorted({r['points'] for r in records})}; the last build's "
        f"timers {records[-1]['timers_s']}")
    log(f"[reconstruct] the window's last model: {window}")
    log(f"[reconstruct] the warm-up's model: {warm} "
        f"(build {seeded['record']['wall_s']:.3f} s)")
    lim = state.params["limits"]
    return [(name + suffix, r[name], lim[name])
            for suffix, r in (("", window), ("_seeded", warm))
            for name in ("registered_miss", "bundle_gain")]
