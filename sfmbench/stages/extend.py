"""Resumed builds at map size: the MapBuilder on a collection whose job
stopped after a COLMAP snapshot, resumed from the snapshot and finished, as
a deployment that writes a snapshot every few registrations resumes.

Set-up makes the collection (`lib/collection.py`: the keypoints and
verified matches of a stated scene, projected through the configuration's
lens in float64) and writes it into a SQLite database with the program's
`Database`, as `sfm-torch extract` and `match` would.  It then writes two
COLMAP snapshots of a converged build of the collection's first views: at
`resume_at` registrations for the window and at `warm_up_resume_at` for the
warm-up.  The collection and the snapshots are the same on every run.

One unit is `cli.cmd_reconstruct` with a resume and without
`write_openmvs`: read the database, `MapBuilder.setup`, `resume_from` the
snapshot and `do_build` to every view on the device, write the COLMAP
model, `cloud.ply` and `cloud_binary.ply`, and take the registered poses
off the map.  The builder's own event log (`enable_metrics`) gives the
route of each global BA; a unit in which no global BA over every
registered view ran on the PCG path raises, so that the cell cannot stop
measuring what it names unnoticed.  The warm-up is one such build resumed
from the later snapshot, every keypoint moved first by Gaussian noise that
the run's seed draws.

The check is `reconstruct`'s, with the keypoints undistorted again by the
plain four-term lens (`reference/opencv_lens.py`): on the window's last
model and on the warm-up's, the share of views left unregistered and the
cost decrease one exact Gauss-Newton step of the points alone, or of the
cameras alone, would still give on the model's own tracks.  The camera
centres' RMS against the truth after a similarity alignment, over the
extent of the views, is logged and not judged.
"""

from __future__ import annotations

import itertools
import json
import pathlib
import shutil
import tempfile
import time

import numpy as np
import torch

from sfmbench.lib import collection
from sfmbench.lib.common import State, camera_of, program_settings
from sfmbench.stages.reconstruct import (_moved, _quiet, _read_database, _view,
                                         sfm_config)


# The MapBuilder's phases that this cell's records and per-layer metrics
# read.  A program without them also has the per-keypoint COLMAP reader and
# writer, 25-30 s a model of this size and three models a build: its run
# would take minutes, so set-up stops it at once instead.
PHASES = ("resume", "ba_assemble", "ba_update")


def setup(state: State) -> State:
    from monocularsfm_torch.config import SfMConfig
    from monocularsfm_torch.reconstruction import MapBuilder

    missing = set(PHASES) - set(MapBuilder(SfMConfig(), device="cpu").timers)
    if missing:
        raise RuntimeError(f"the program's MapBuilder has no {sorted(missing)} "
                           f"phases, which this cell reports")
    parts, config = state.info["setup_parts"], state.config
    t0 = time.perf_counter()
    cam = camera_of(config)
    work = pathlib.Path(tempfile.mkdtemp(prefix="sfmbench-extend-"))
    state.program.update(work=work, out=work / "out")
    cfg = sfm_config(program_settings(state), str(work / "out"),
                     str(work / "collection.db"))
    state.program["cfg"] = cfg
    settings, scene = config["settings"], config["scene"]
    coll = collection.make(scene, cam, config["views"],
                           settings["extraction"]["num_features"],
                           settings["matching"]["overlap"],
                           config["observations_per_view"])
    parts["collection_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ids = collection.write_database(coll, cfg.database_path)
    parts["database_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dirs = {}
    for key in ("resume_at", "warm_up_resume_at"):
        state.program[key] = dirs[state.params[key]] = (
            work / f"snapshot{state.params[key]}")
    counts = collection.write_snapshots(coll, collection.perturbed(coll, scene),
                                        ids, dirs, scene["snapshot_min_angle_deg"],
                                        state.device)
    state.log(f"[extend] snapshots by registrations: {counts}")
    parts["snapshots_s"] = time.perf_counter() - t0
    state.truth.update(R=coll.R, t=coll.t)
    state.log(f"[extend] {config['views']} views of {cam['width']}x"
              f"{cam['height']}: {len(coll.X)} points, {len(coll.obs_point)} "
              f"observations, {len(coll.matches)} pairs, {coll.outliers} wrong "
              f"matches")
    return state


def build(state: State, snapshot, noise=None) -> tuple[dict, dict, dict]:
    """One resumed reconstruction from the database; with `noise` (sigma in
    px, a numpy Generator), every keypoint is moved by Gaussian noise first.
    Returns (the unit's record, the model, the keypoints built from)."""
    from monocularsfm_torch.io import write_colmap, write_ply, write_ply_binary
    from monocularsfm_torch.reconstruction import MapBuilder

    cfg, device, out = state.program["cfg"], state.device, state.program["out"]
    events = state.program["work"] / "events.jsonl"
    events.unlink(missing_ok=True)
    t0 = time.perf_counter()
    names, keypoints, colors, matches = _read_database(cfg.database_path)
    if noise is not None:
        sigma, rng = noise
        keypoints = {i: _moved(keypoints[i], sigma, rng) for i in sorted(keypoints)}
    builder = MapBuilder(cfg, device=device)
    builder._log = _quiet
    builder.enable_metrics(events)
    try:
        builder.setup(matches, keypoints, colors=colors, names=names)
        builder.resume_from(snapshot)
        resumed = len(builder.map.registered_ids)
        summary = builder.do_build()
    finally:
        builder.close()
    write_colmap(builder.map, out / "colmap")
    write_ply(builder.map, out / "cloud.ply")
    write_ply_binary(builder.map, out / "cloud_binary.ply")
    poses = {i: (builder.map.images[i].R.copy(), builder.map.images[i].t.copy())
             for i in sorted(builder.map.registered_ids)}
    wall = time.perf_counter() - t0
    routes = [(e["cams"], e["solver"]) for e in
              map(json.loads, events.read_text().splitlines())
              if e["event"] == "global_ba"]
    if (summary.num_registered, "pcg") not in routes:
        raise RuntimeError(f"no global BA over the {summary.num_registered} "
                           f"registered views ran on the PCG path: {routes}")
    record = {"wall_s": wall, "resumed": resumed,
              "registered": summary.num_registered,
              "points": summary.num_points3D,
              "observations": summary.num_observations,
              "global_ba": routes,
              "timers_s": {k: round(v, 4) for k, v in summary.timers.items()}}
    return record, dict(map=builder.map, poses=poses, names=names), keypoints


def warm_up(state: State) -> None:
    """One build resumed from the warm-up's snapshot, its keypoints moved by
    the seed's noise: the window's path, the program's first-use costs
    paid, on data that differs from run to run."""
    rng = np.random.default_rng(np.random.SeedSequence(
        [int(state.seed) % 2 ** 63, int(state.config["scene"]["scene_seed"])]))
    record, model, keypoints = build(
        state, state.program["warm_up_resume_at"],
        noise=(state.params["warm_up_noise_px"], rng))
    state.truth["seeded"] = dict(model, keypoints=keypoints, record=record)
    state.log(f"[extend] warm-up build: {record}")


def unit(state: State) -> dict:
    record, model, keypoints = build(state, state.program["resume_at"])
    state.program["result"] = dict(model, keypoints=keypoints)
    return record


def end_to_end(records, window_s) -> dict:
    return {"reconstruct_s": window_s / len(records)}


def _readings(state: State, model: dict, keypoints: dict) -> dict:
    """registered_miss, pose_miss and bundle_gain of one model."""
    from sfmbench.reference import geometry
    from sfmbench.reference.opencv_lens import undistort_pixels

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
    pids = m.point_ids()
    tracks = [m.track(int(p)) for p in pids]
    lens = [len(tr) for tr in tracks]
    obs = np.fromiter(itertools.chain.from_iterable(itertools.chain.from_iterable(
        tracks)), np.int64, 2 * sum(lens)).reshape(-1, 2)
    if not len(obs):
        return dict(out, bundle_gain=float("inf"))
    X = np.stack([m.xyz(int(p)) for p in pids])
    pt_idx = np.repeat(np.arange(len(pids)), lens)
    cam_idx = np.searchsorted(reg, obs[:, 0])
    first = np.cumsum([0] + [len(keypoints[i]) for i in reg])[cam_idx]
    kp = np.concatenate([keypoints[i][:, :2] for i in reg]).astype(np.float64)[
        first + obs[:, 1]]
    dev = state.device
    uv = undistort_pixels(torch.as_tensor(kp, device=dev), cam)
    K = np.array([cam["fx"], cam["fy"], cam["cx"], cam["cy"]])
    g = geometry.bundle_gain(
        K, torch.as_tensor(R, device=dev), torch.as_tensor(t, device=dev),
        torch.as_tensor(X, device=dev), torch.as_tensor(cam_idx, device=dev),
        torch.as_tensor(pt_idx, device=dev), uv)
    out["bundle_gain"] = g["point_gain"] + g["camera_gain"]
    out["reprojection_px"] = g["mean_reproj_px"]
    out["points"], out["observations"] = len(pids), len(obs)
    return out


def check(state: State, records, log) -> list:
    model = state.program.pop("result")
    shutil.rmtree(state.program.pop("work"), ignore_errors=True)
    state.program.clear()
    window = _readings(state, model, model["keypoints"])
    seeded = state.truth["seeded"]
    warm = _readings(state, seeded, seeded["keypoints"])
    log(f"[extend] builds {len(records)}, walls "
        f"{[round(r['wall_s'], 3) for r in records]} s, registered "
        f"{sorted({r['registered'] for r in records})}, points "
        f"{sorted({r['points'] for r in records})}, global BAs "
        f"{records[-1]['global_ba']}; the last build's timers "
        f"{records[-1]['timers_s']}")
    log(f"[extend] the window's last model: {window}")
    log(f"[extend] the warm-up's model: {warm} "
        f"(build {seeded['record']['wall_s']:.3f} s)")
    lim = state.params["limits"]
    return [(name + suffix, r[name], lim[name])
            for suffix, r in (("", window), ("_seeded", warm))
            for name in ("registered_miss", "bundle_gain")]
