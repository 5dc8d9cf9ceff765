"""The multi-device dry run, and the rank-side steps that tests, tools and
the smoke run in spawned worlds.

`dryrun_multichip(n)` is the port of the JAX package's
`__graft_entry__.dryrun_multichip`: over n spawned ranks it runs
landmark-sharded BA on a tiny problem, pair-sharded matching, ring
all-pairs matching, and the MapBuilder on an 8-camera 150-degree ring with
global BA forced onto the sharded PCG path.

Every step below is SPMD: each rank of a world made by `mesh.spawn` (or
`torchrun`) calls it with the same arguments; arrays come in and go out as
numpy, so a caller need not import torch's distributed state.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from monocularsfm_torch.parallel import mesh as M


def tiny_problem(num_cams: int = 6, num_points: int = 64, T: int = 4,
                 seed: int = 0):
    """A small perturbed ring problem (the JAX package's `_tiny_problem`)."""
    from monocularsfm_torch.optim import make_bundle_problem
    from monocularsfm_torch.utils.synthetic import camera_ring_scene

    scene = camera_ring_scene(num_cameras=num_cams, num_points=num_points,
                              noise_px=0.3, seed=seed)
    rng = np.random.default_rng(seed)
    P = scene.num_points
    obs_cam = np.zeros((P, T), np.int32)
    obs_uv = np.zeros((P, T, 2), np.float32)
    obs_valid = np.zeros((P, T), bool)
    for p in range(P):
        cams = np.where(scene.visible[:, p])[0][:T]
        obs_cam[p, :len(cams)] = cams
        obs_uv[p, :len(cams)] = scene.observations[cams, p]
        obs_valid[p, :len(cams)] = True
    cam_const = np.zeros(num_cams, bool)
    cam_const[0] = True
    K4 = np.array([scene.K[0, 0], scene.K[1, 1], scene.K[0, 2], scene.K[1, 2]],
                  np.float32)
    R = scene.R + rng.normal(scale=0.002, size=scene.R.shape)
    X = scene.points + rng.normal(scale=0.01, size=scene.points.shape)
    return make_bundle_problem(K4, R, scene.t, X, obs_cam, obs_uv, obs_valid,
                               cam_const)


def _host(out: dict) -> dict:
    return {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


# -- SPMD steps -----------------------------------------------------------

def ba(arrays: dict, device="cpu", **kwargs) -> dict:
    """distributed_bundle_adjust of the problem given as numpy arrays
    (BundleProblem's fields); bundle_adjust's dict in numpy.  A ValueError
    of the solver comes back as {"error": message}."""
    from monocularsfm_torch.optim.ba import BundleProblem
    from monocularsfm_torch.parallel import distributed_bundle_adjust

    prob = BundleProblem(**{k: torch.from_numpy(np.asarray(v))
                            for k, v in arrays.items()})
    try:
        out = distributed_bundle_adjust(prob, M.make_mesh(device=device), **kwargs)
    except ValueError as e:
        return {"error": str(e)}
    return _host(out)


def ring_ba(cams: int, points: int, track: int, seed: int, device="cuda",
            **kwargs) -> dict:
    """distributed_bundle_adjust of the bench's ring problem, built on every
    rank: a warm-up solve of 2 LM iterations, then the timed solve (its
    wall, and the seconds inside collectives with the device synchronised
    around each)."""
    from monocularsfm_torch.parallel import distributed_bundle_adjust
    from monocularsfm_torch.utils.ring_problem import ring_problem

    prob, nobs = ring_problem(cams, points, track, seed=seed)
    mesh = M.make_mesh(device=device)
    dev = M.mesh_device(mesh)
    prob = prob.to(dev)
    warm = dict(kwargs, max_iterations=2)
    distributed_bundle_adjust(prob, mesh, **warm)
    M.reset_stats(timed=True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = distributed_bundle_adjust(prob, mesh, **kwargs)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = dict(M.STATS)
    M.reset_stats()
    return {"obs": nobs, "iterations": out["iterations"],
            "cg_steps": out["cg_steps"],
            "rmse_final": float(out["rmse_final"]),
            "cost_final": float(out["cost_final"]), "wall_s": wall,
            "collective_s": stats["seconds"], "collective_calls": stats["calls"],
            "collective_bytes": stats["bytes"],
            "backend": dist.get_backend(), "device": str(dev)}


def match(bank: np.ndarray, mask: np.ndarray, pairs: np.ndarray,
          device="cpu", **kwargs) -> dict:
    """sharded_match_pairs; the index maps and this rank's launches of the
    matcher kernel (0 on the CPU)."""
    from monocularsfm_torch.ops import match_kernel
    from monocularsfm_torch.parallel import sharded_match_pairs

    mesh = M.make_mesh(device=device)
    dev = M.mesh_device(mesh)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    before = match_kernel.LAUNCHES["match_tile"]
    idx = sharded_match_pairs(torch.from_numpy(bank).to(dev, dtype),
                              torch.from_numpy(mask).to(dev), pairs, mesh,
                              **kwargs)
    return {"idx": idx.cpu().numpy(),
            "launches": match_kernel.LAUNCHES["match_tile"] - before}


def bank_query(query: np.ndarray, qmask: np.ndarray, bank: np.ndarray,
               mask: np.ndarray, device="cpu", **kwargs) -> np.ndarray:
    """ring_bank_matching of one query image against the bank."""
    from monocularsfm_torch.parallel.sharded_matching import ring_bank_matching

    mesh = M.make_mesh(device=device)
    return ring_bank_matching(query, bank, qmask, mask, mesh,
                              **kwargs).cpu().numpy()


def ring(bank: np.ndarray, mask: np.ndarray, device="cpu", **kwargs) -> dict:
    """ring_all_pairs_matching; its dict and this rank's kernel launches."""
    from monocularsfm_torch.ops import match_kernel
    from monocularsfm_torch.parallel import ring_all_pairs_matching

    before = match_kernel.LAUNCHES["match_tile"]
    res = ring_all_pairs_matching(bank, mask, M.make_mesh(device=device),
                                  **kwargs)
    return {"pairs": res,
            "launches": match_kernel.LAUNCHES["match_tile"] - before}


class ReplayDraws:
    """Stands in for a matcher's `_draw`: uniforms given by the caller, in
    order; each call must ask for the shape recorded beside its draws."""

    def __init__(self, draws, device="cpu"):
        self.draws = list(draws)
        self.device = device

    def __call__(self, shape):
        d = self.draws.pop(0)
        if tuple(d.shape) != tuple(shape):
            raise ValueError(f"replayed draws of shape {d.shape}, asked {shape}")
        return torch.from_numpy(d).to(self.device)


def matcher(db_path: str, mcfg, par, device="cpu", draws=None) -> dict:
    """Rank 0 runs the brute matcher on `db_path` with ParallelConfig `par`
    (F-RANSAC with `draws` when given); the other ranks serve.  Returns
    the pairs written (None off rank 0) and this rank's kernel launches."""
    from monocularsfm_torch.features.matching import BruteFeatureMatcher
    from monocularsfm_torch.ops import match_kernel
    from monocularsfm_torch.parallel import serve

    def run():
        m = BruteFeatureMatcher(mcfg, parallel=par, device=device)
        if draws is not None:
            m._draw = ReplayDraws(draws, m.device)
        n = m.run_matching(db_path, log=lambda *a: None)
        if draws is not None and m._draw.draws:
            raise ValueError(f"{len(m._draw.draws)} replayed draws unused")
        return n

    before = match_kernel.LAUNCHES["match_tile"]
    n = serve.run_controller(run, device=device)
    return {"written": n, "launches": match_kernel.LAUNCHES["match_tile"] - before}


def ring_scene_inputs(num_cameras: int = 8, num_points: int = 200,
                      seed: int = 4, arc_deg: float = 150.0,
                      noise_px: float = 0.2):
    """The dry run's MapBuilder input: a ring scene, its keypoints with
    `noise_px` of noise, and the true matches of every pair that shares at
    least 8 points.  Returns (scene, matches, keypoints)."""
    from monocularsfm_torch.utils.synthetic import camera_ring_scene

    scene = camera_ring_scene(num_cameras=num_cameras, num_points=num_points,
                              seed=seed, arc_deg=arc_deg)
    rng = np.random.default_rng(seed)
    keypoints, kpt_of = {}, {}
    for c in range(scene.num_cameras):
        vis = np.nonzero(scene.visible[c])[0]
        keypoints[c] = (scene.observations[c][vis]
                        + rng.normal(scale=noise_px, size=(len(vis), 2))
                        ).astype(np.float32)
        kpt_of[c] = {int(p): k for k, p in enumerate(vis)}
    matches = {}
    for i in range(scene.num_cameras):
        for j in range(i + 1, scene.num_cameras):
            common = np.nonzero(scene.visible[i] & scene.visible[j])[0]
            if len(common) >= 8:
                matches[(i, j)] = np.array(
                    [[kpt_of[i][int(p)], kpt_of[j][int(p)]] for p in common],
                    np.int32)
    return scene, matches, keypoints


def dryrun_config(scene, world: int):
    """The dry run's SfMConfig: the scene's intrinsics, sharded BA on a mesh
    of the whole world, global BA forced onto PCG from 3 images, 8 LM
    iterations."""
    from monocularsfm_torch.config import SfMConfig

    cfg = SfMConfig()
    cfg.camera.fx, cfg.camera.fy = float(scene.K[0, 0]), float(scene.K[1, 1])
    cfg.camera.cx, cfg.camera.cy = float(scene.K[0, 2]), float(scene.K[1, 2])
    cfg.parallel.shard_ba = True
    cfg.parallel.mesh_shape = (world,)
    cfg.bundle.dense_max_images = 2   # force the sharded PCG branch
    cfg.bundle.max_iterations = 8
    return cfg


def builder(cfg, matches: dict, keypoints: dict, device="cpu") -> dict | None:
    """Rank 0 builds a map with the MapBuilder (the other ranks serve its
    global BAs); returns the summary, the registered poses and the event
    log on rank 0, None elsewhere."""
    from monocularsfm_torch.parallel import serve
    from monocularsfm_torch.reconstruction import MapBuilder

    def run():
        b = MapBuilder(cfg, device=device)
        b._log = lambda *a: None
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "events.jsonl")
            b.enable_metrics(path)
            try:
                b.setup(matches, keypoints)
                s = b.do_build()
            finally:
                b.close()
            with open(path) as f:
                events = [json.loads(line) for line in f]
        m = b.map
        return {"num_registered": s.num_registered,
                "num_points3D": s.num_points3D,
                "mean_reprojection_error": s.mean_reprojection_error,
                "registered_ids": sorted(m.registered_ids),
                "poses": {i: (m.images[i].R, m.images[i].t)
                          for i in m.registered_ids},
                "events": events, "mesh": b._ba_mesh() is not None}

    return serve.run_controller(run, device=device)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dry run: {what}")


def _dryrun_rank(device="cuda") -> dict:
    """One rank's part of the dry run; rank 0's dict carries the results."""
    n = dist.get_world_size()
    # 1. Landmark-sharded BA: points and observations sharded, cameras
    #    replicated, the camera system all-reduced, local back-substitution.
    prob = tiny_problem(num_cams=6, num_points=8 * max(n, 2), T=4)
    out = ba({k: v.numpy() for k, v in prob.tensors().items()}, device,
             max_iterations=3)
    _check(np.isfinite(out["cost_final"]) and out["X"].shape == tuple(prob.X.shape),
           f"distributed BA gave cost {out['cost_final']}, X {out['X'].shape}")
    # 2. Pair-sharded matching: the pair list sharded, the bank replicated.
    rng = np.random.default_rng(0)
    cap, n_img = 256, 4
    bank = rng.normal(size=(n_img, cap, 128)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=-1, keepdims=True)
    mask = np.ones((n_img, cap), bool)
    pairs = np.array([[i, j] for i in range(n_img) for j in range(i + 1, n_img)],
                     np.int32)
    idx = match(bank, mask, pairs, device, col_tile=cap)["idx"]
    _check(idx.shape == (len(pairs), cap), f"sharded matching gave {idx.shape}")
    # 3. Ring all-pairs matching: the bank sharded, shards rotated.
    n_ring = 2 * n
    bank_r = rng.normal(size=(n_ring, cap, 128)).astype(np.float32)
    bank_r /= np.linalg.norm(bank_r, axis=-1, keepdims=True)
    res = ring(bank_r, np.ones((n_ring, cap), bool), device, col_tile=cap)["pairs"]
    _check(all(v.ndim == 2 and v.shape[1] == 2 for v in res.values()),
           "ring matching rows are not (m, 2)")
    # 4. The pipeline path: the MapBuilder's global BA on the mesh.
    scene, matches, keypoints = ring_scene_inputs()
    built = builder(dryrun_config(scene, n), matches, keypoints, device)
    if built is None:
        return {}
    gba = [e for e in built["events"] if e["event"] == "global_ba"]
    _check(built["num_registered"] >= scene.num_cameras - 1,
           f"{built['num_registered']} of {scene.num_cameras} registered")
    _check(built["mesh"] and gba and all(e["sharded"] for e in gba),
           f"global BA not sharded: {gba}")
    return {"ba_cost_final": float(out["cost_final"]), "ring_pairs": len(res),
            "matched": int((idx >= 0).sum()), **built}


def dryrun_multichip(n_devices: int, device="cuda", timeout: float = 300.0) -> dict:
    """The four sharded steps over `n_devices` spawned ranks (one device
    each, or gloo ranks sharing a card or the CPU); raises if a step
    fails.  Returns rank 0's results: the builder's summary, poses and
    global-BA events among them."""
    return M.spawn(n_devices, [("monocularsfm_torch.parallel.dryrun:_dryrun_rank",
                                (device,), {})], device=device, timeout=timeout)[0][0]
