"""The final global bundle adjustment as the MapBuilder calls it.

Set-up builds on the device a bundle at the deployment's published size:
cameras spread over an arc around a cloud of points, each point seen by a
run of neighbouring cameras (tracks of the configured mean length), its
observations with Gaussian pixel noise, and the start perturbed from the
truth as after incremental registration.  Its layout is the MapBuilder's
for a bundle over `dense_max_images` images: rows of `track_width`
observations, capacities in powers of two, camera 0 pinned
(`map_state._ba_problem_from`, `map_builder.global_ba`).  One unit is
`optim.bundle_adjust` on it with the configuration's tolerances and limits,
the result brought back to the host as the MapBuilder brings it.

The window's bundle is the same for every seed: LM's stopping iteration
follows the rounding of its sums, and reordering the points alone moved it
between 26 and 42.  The warm-up solves a bundle of the same layout whose
noise and start the run's seed draws, so the check also sees data that
differs from run to run.

The check evaluates both solves' cameras and points in float64
(`reference/geometry.py`): how much one exact Gauss-Newton step of the
points alone, or of the cameras alone, would still lower the cost.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from sfmbench.lib.common import State, camera_of, program_settings


def pow2_bucket(x: int, minimum: int) -> int:
    cap = minimum
    while cap < x:
        cap *= 2
    return cap


def _look_at(C: torch.Tensor) -> torch.Tensor:
    """World-to-camera rotations of cameras at C (n, 3) facing the origin."""
    z = -C / torch.linalg.norm(C, dim=1, keepdim=True)
    up = torch.tensor([0.0, -1.0, 0.0], dtype=C.dtype, device=C.device)
    x = torch.linalg.cross(up.expand_as(z), z)
    x = x / torch.linalg.norm(x, dim=1, keepdim=True)
    y = torch.linalg.cross(z, x)
    return torch.stack([x, y, z], 1)


def _rodrigues(w: torch.Tensor) -> torch.Tensor:
    th = torch.linalg.norm(w, dim=1, keepdim=True).clamp(min=1e-12)
    k = w / th
    Kx = torch.zeros((len(w), 3, 3), dtype=w.dtype, device=w.device)
    Kx[:, 0, 1], Kx[:, 0, 2] = -k[:, 2], k[:, 1]
    Kx[:, 1, 0], Kx[:, 1, 2] = k[:, 2], -k[:, 0]
    Kx[:, 2, 0], Kx[:, 2, 1] = -k[:, 1], k[:, 0]
    s, c = torch.sin(th)[:, :, None], torch.cos(th)[:, :, None]
    return torch.eye(3, dtype=w.dtype, device=w.device) + s * Kx + (1 - c) * Kx @ Kx


def make_problem(ba: dict, cam: dict, device, seed: int | None = None):
    """(problem tensors on `device`, truth, counts).  The bundle is drawn,
    in a few calls, from one device generator seeded with the deployment's
    `problem_seed`; with `seed`, its noise and start come from a second
    generator seeded from `seed`, on the same layout."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(ba["problem_seed"]))
    n_cam, n_pt, T = ba["cameras"], ba["points"], ba["track_width"]
    f64 = torch.float64
    ang = torch.linspace(-math.radians(ba["arc_deg"]) / 2,
                         math.radians(ba["arc_deg"]) / 2, n_cam,
                         dtype=f64, device=dev)
    r = ba["radius"]
    C = torch.stack([r * torch.sin(ang), 0.35 * r * torch.sin(2 * ang),
                     -r * torch.cos(ang)], 1)
    R = _look_at(C)
    t = -torch.einsum("cij,cj->ci", R, C)
    X = (torch.rand((n_pt, 3), generator=gen, device=dev, dtype=f64) * 4 - 2)
    X[:, 2] *= 0.6
    # Track lengths 2 + Poisson(mean - 2), at most T; a run of neighbouring
    # cameras from a random first one.
    lam = torch.full((n_pt,), float(ba["mean_track"] - 2), dtype=f64, device=dev)
    L = (2 + torch.poisson(lam, generator=gen)).clamp(max=T).long()
    first = (torch.rand(n_pt, generator=gen, device=dev, dtype=f64)
             * (n_cam - L + 1)).long()
    slot = torch.arange(T, device=dev)
    obs_cam = (first[:, None] + slot[None, :]).clamp(max=n_cam - 1)
    valid = slot[None, :] < L[:, None]
    xc = torch.einsum("pkij,pj->pki", R[obs_cam], X) + t[obs_cam]
    fx, fy, cx, cy = cam["fx"], cam["fy"], cam["cx"], cam["cy"]
    uv = torch.stack([fx * xc[..., 0] / xc[..., 2] + cx,
                      fy * xc[..., 1] / xc[..., 2] + cy], -1)
    valid &= ((xc[..., 2] > 0.2) & (uv[..., 0] >= 0) & (uv[..., 0] < cam["width"])
              & (uv[..., 1] >= 0) & (uv[..., 1] < cam["height"]))
    if seed is not None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(np.random.SeedSequence(
            [int(seed) % 2 ** 63, int(ba["problem_seed"])]).generate_state(
                1, np.uint64)[0]))
    noise = torch.randn(uv.shape, generator=gen, device=dev, dtype=torch.float32)
    uv = (uv.float() + ba["noise_px"] * noise) * valid[..., None]
    w = torch.randn((n_cam, 3), generator=gen, device=dev, dtype=f64) * ba["rot_perturb"]
    R0 = _rodrigues(w) @ R
    t0 = t + torch.randn((n_cam, 3), generator=gen, device=dev, dtype=f64) * ba["t_perturb"]
    X0 = X + torch.randn((n_pt, 3), generator=gen, device=dev, dtype=f64) * ba["x_perturb"]
    R0[0], t0[0] = R[0], t[0]          # camera 0 pinned at its true pose
    C_cap, P_cap = pow2_bucket(n_cam, 8), pow2_bucket(n_pt, 256)

    def pad(a, n, fill=0):
        out = torch.full((n,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                         device=dev)
        out[:len(a)] = a
        return out

    eye = torch.eye(3, dtype=f64, device=dev).expand(C_cap - n_cam, 3, 3)
    tensors = dict(
        K=torch.tensor([fx, fy, cx, cy], dtype=torch.float32, device=dev),
        R=torch.cat([R0, eye]).float(), t=pad(t0, C_cap).float(),
        X=pad(X0, P_cap).float(),
        cam_valid=pad(torch.ones(n_cam, dtype=torch.bool, device=dev), C_cap, False),
        cam_const=pad(torch.arange(n_cam, device=dev) == 0, C_cap, False),
        point_valid=pad(valid.sum(1) >= 2, P_cap, False),
        obs_cam=pad(torch.where(valid, obs_cam, 0), P_cap),
        obs_uv=pad(uv, P_cap), obs_valid=pad(valid, P_cap, False),
        point_rows=torch.cat([torch.arange(n_pt, device=dev),
                              torch.full((P_cap - n_pt,), P_cap - 1, device=dev)]))
    truth = {"R": R.cpu().numpy(), "t": t.cpu().numpy()}
    counts = {"observations": int(valid.sum()), "points": n_pt, "cameras": n_cam}
    return tensors, truth, counts


def solve_kwargs(bundle: dict) -> dict:
    """bundle_adjust's arguments as map_builder.global_ba passes them for
    a bundle of `min_images_tight` images or more on the PCG path."""
    return dict(max_iterations=bundle["max_iterations"],
                function_tolerance=bundle["function_tolerance"],
                parameter_tolerance=bundle["parameter_tolerance"],
                gradient_tolerance=bundle["gradient_tolerance"],
                initial_radius=bundle["initial_trust_radius"],
                min_lm_diagonal=bundle["min_lm_diagonal"],
                max_lm_diagonal=bundle["max_lm_diagonal"],
                solve_mode="pcg", pcg_iters=bundle["pcg_iterations"])


def setup(state: State) -> State:
    import dataclasses

    from monocularsfm_torch.config import BundleConfig
    from monocularsfm_torch.optim import BundleProblem

    config, params, device = state.config, state.params, state.device
    t0 = time.perf_counter()
    cam = camera_of(config)
    ba = dict(config["ba"], **params.get("ba", {}))
    bundle = dataclasses.asdict(BundleConfig())
    bundle.update(program_settings(state).get("bundle", {}))
    ba["track_width"] = bundle["track_width"]
    tensors, truth, counts = make_problem(ba, cam, device)
    state.program["prob"] = BundleProblem(**tensors)
    tensors, _, seeded = make_problem(ba, cam, device, seed=state.seed)
    state.program["seeded"] = BundleProblem(**tensors)
    state.program["kwargs"] = solve_kwargs(bundle)
    state.truth.update(truth)
    state.info.update(counts)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    state.info["setup_parts"]["problem_s"] = time.perf_counter() - t0
    state.log(f"[global_ba] {counts}; the seed's bundle {seeded}")
    return state


def warm_up(state: State) -> None:
    """One solve of the seed's bundle: the window's shapes and path.  Its
    result and observations wait on the host for the check."""
    from monocularsfm_torch.optim import bundle_adjust

    prob = state.program.pop("seeded")
    out = bundle_adjust(prob, device=state.device, **state.program["kwargs"])
    state.truth["seeded"] = dict(
        _observations(prob, state.info["points"], state.info["cameras"], "cpu"),
        **{k: out[k].cpu() for k in ("R", "t", "X")},
        iterations=int(out["iterations"]), radius=float(out["radius"]))


def unit(state: State) -> dict:
    from monocularsfm_torch.optim import bundle_adjust

    t0 = time.perf_counter()
    out = bundle_adjust(state.program["prob"], device=state.device,
                        **state.program["kwargs"])
    out = {k: v.cpu() if isinstance(v, torch.Tensor) else v
           for k, v in out.items()}
    wall = time.perf_counter() - t0
    state.program["result"] = out
    return {"solves": 1, "wall_s": wall, "iterations": int(out["iterations"]),
            "cg_steps": int(out["cg_steps"]),
            "cost_final": float(out["cost_final"])}


def end_to_end(records, window_s) -> dict:
    return {"global_ba_s": window_s / len(records)}


def _observations(prob, n_pt: int, n_cam: int, device) -> dict:
    """The bundle's valid observations as (camera, point, pixel) rows, its
    pinned cameras and K, on `device`."""
    pt, slot = torch.nonzero(prob.obs_valid[:n_pt], as_tuple=True)
    return {"cam": prob.obs_cam[:n_pt][pt, slot].to(device),
            "pt": pt.to(device), "uv": prob.obs_uv[:n_pt][pt, slot].to(device),
            "const": prob.cam_const[:n_cam].to(device),
            "K": prob.K.double().cpu().numpy()}


def _gain(sol: dict, n_cam: int, n_pt: int, device) -> dict:
    from sfmbench.reference import geometry

    return geometry.bundle_gain(
        sol["K"], sol["R"][:n_cam].to(device), sol["t"][:n_cam].to(device),
        sol["X"][:n_pt].to(device), sol["cam"].to(device), sol["pt"].to(device),
        sol["uv"].to(device), cam_const=sol["const"].to(device))


def check(state: State, records, log) -> list:
    from sfmbench.reference import geometry

    n_cam, n_pt = state.info["cameras"], state.info["points"]
    prob = state.program.pop("prob")
    out = state.program.pop("result")
    window = dict(_observations(prob, n_pt, n_cam, prob.obs_uv.device),
                  **{k: out[k] for k in ("R", "t", "X")})
    del prob
    state.program.clear()
    if torch.device(state.device).type == "cuda":
        torch.cuda.empty_cache()
    g = _gain(window, n_cam, n_pt, state.device)
    del window
    seeded = state.truth["seeded"]
    gs = _gain(seeded, n_cam, n_pt, state.device)
    C = geometry.centres(out["R"][:n_cam].double().numpy(),
                         out["t"][:n_cam].double().numpy())
    C_true = geometry.centres(state.truth["R"], state.truth["t"])
    s, Rs, ts = geometry.umeyama(C, C_true)
    err = np.linalg.norm(s * C @ Rs.T + ts - C_true, axis=1)
    extent = float(np.linalg.norm(np.ptp(C_true, axis=0)))
    gap = abs(float(out["cost_final"]) - g["cost"]) / g["cost"]
    log(f"[global_ba] solves {len(records)}, iterations "
        f"{sorted({r['iterations'] for r in records})}, cg steps "
        f"{sorted({r['cg_steps'] for r in records})}, walls "
        f"{[round(r['wall_s'], 3) for r in records]} s; reference cost "
        f"{g['cost']:.6e} (program {float(out['cost_final']):.6e}, gap "
        f"{gap:.3e}), reprojection {g['mean_reproj_px']:.5f} px, point gain "
        f"{g['point_gain']:.3e}, camera gain {g['camera_gain']:.3e}, centres "
        f"{err.max() / extent:.3e} of the extent")
    log(f"[global_ba] the seed's bundle: iterations {seeded['iterations']} "
        f"(trust radius at the stop {seeded['radius']:.3e}), "
        f"reference cost {gs['cost']:.6e}, reprojection "
        f"{gs['mean_reproj_px']:.5f} px, point gain {gs['point_gain']:.3e}, "
        f"camera gain {gs['camera_gain']:.3e}")
    lim = state.params["limits"]["bundle_gain"]
    return [("bundle_gain", g["point_gain"] + g["camera_gain"], lim),
            ("bundle_gain_seeded", gs["point_gain"] + gs["camera_gain"], lim)]
