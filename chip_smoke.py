"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from monocularsfm_torch/csrc, checks each against its
plain PyTorch version on the card at the main path's shapes (the matcher
over 16 pairs at capacity 8192, plus a case of exact ties and a fully
masked image that must equal the plain statistics), times each beside its
plain version, the bound of its work and one library call of the same
function where there is one, checks the port's SIFT on the card
against the same SIFT on the CPU, then drives the port's extract and match
stages (`sfm-torch extract`, `match`, `check-matches`) on 8 rendered
1280x960 images at the default configuration.  Then bundle adjustment on
the card: the dense Schur solver on a 128-camera / 40k-point ring (against
the same solve on the CPU) and the PCG solver on a 1024-camera /
200k-point ring with split tracks.  Last, `sfm-torch pipeline` (extract,
match, reconstruct, export) on 32 rendered 1280x960 views of a
multi-plane scene, checked against the true poses.  It stops at the first
failure with a non-zero exit.  The last three lines of standard output are
the card's name and power limit (nvidia-smi), one JSON object describing
the kernels and the measured rates, and {"ok": true, "device": {...}}.
Logs go to stderr.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
BLUR_SHAPE = (4, 1920, 2560)    # octave 0 of a 4-image batch at 1280x960
BLUR_TOL = 1e-5
MATCH_CAP, MATCH_IMAGES = 8192, 16   # one batch of 16 pairs (config.py)
MATCH_AGREE = 0.999
SIM_TOL = 1e-4                  # f32 sums of 128 bf16 products, any order
SIFT_SIZE = (480, 640)
KP_TOL, DESC_TOL, KP_AGREE = 0.01, 2e-3, 0.99
SLICE_IMAGES, SLICE_W, SLICE_H = 8, 1280, 960
MIN_VERIFIED = 15
MIN_KEYPOINTS = 1000            # per 1280x960 view (about 8000 expected)
# Bundle adjustment: the repo bench's camera-ring problems.
BA_CAMS, BA_POINTS, BA_TRACK, BA_ITERS = 128, 40_000, 8, 50
PCG_CAMS, PCG_POINTS, PCG_TRACK, PCG_LM_ITERS, PCG_INNER = 1024, 200_000, 6, 10, 50
RMSE_MAX = 0.5                  # px; the 0.5 px noise gives about 0.45
CUDA_CPU_RTOL = 1e-4            # cost after 1..3 LM iterations, card vs CPU
# Rates are taken over a fixed amount of work: with the stopping tolerances
# at 0, LM runs all its iterations and CG all its steps.
FIXED_WORK = dict(function_tolerance=0.0, parameter_tolerance=0.0,
                  gradient_tolerance=0.0, pcg_rtol=0.0)
PCG_DENSE_TOL = 2e-3            # px of rmse_final, PCG vs dense, 128 cameras
# Pipeline: tools/scale_run.py's recipe at 32 views (mp128 camera spacing).
MP_VIEWS, MP_W, MP_H, MP_SEED = 32, 1280, 960, 7
MP_ARC_PER_VIEW = 200.0 / 128
MP_REPROJ_MAX, MP_CENTER_PCT_MAX, MP_MIN_POINTS = 0.5, 0.1, 5000


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def fail(msg: str):
    log(f"FAIL: {msg}")
    sys.exit(1)


def time_ms(fn, reps: int = 10) -> float:
    """Mean device time of fn() in ms, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    log(f"[device] {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | {line}")
    return line


def phase_build():
    from monocularsfm_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.2f}s "
        f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'})")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "C75" in line:
            log(f"[build] {line.strip()}")


def check_blur(dev):
    import torch.nn.functional as F

    from monocularsfm_torch.ops import blur
    from monocularsfm_torch.ops.sift import _OCT_KER, gaussian_kernel1d, SIGMA0, INIT_SIGMA
    from monocularsfm_torch.utils import roofline

    g = torch.Generator(dev).manual_seed(SEED)
    base = torch.rand(BLUR_SHAPE, generator=g, device=dev)
    kb = gaussian_kernel1d(math.sqrt(SIGMA0 ** 2 - 4.0 * INIT_SIGMA ** 2))
    rows = []
    for name, taps_np in (("base C=1 T=9", kb[None]), ("octave C=5 T=31", _OCT_KER)):
        host = torch.as_tensor(taps_np)
        taps = host.to(dev)
        v_k, v_p = blur.blur_v(base, host), blur.blur_v_plain(base, taps)
        h_k, h_p = blur.blur_h(v_p, taps), blur.blur_h_plain(v_p, taps)
        full = (blur.blur_multi(base, host)
                - blur.blur_multi_plain(base, taps)).abs().max().item()
        err_v = (v_k - v_p).abs().max().item()
        err_h = (h_k - h_p).abs().max().item()
        if not (err_v <= BLUR_TOL and err_h <= BLUR_TOL and full <= BLUR_TOL):
            fail(f"blur {name}: max abs err v {err_v} h {err_h} both {full} "
                 f"> {BLUR_TOL}")
        C, T = taps.shape
        r = (T - 1) // 2
        pad_v = F.pad(base[:, None], (0, 0, r, r), mode="replicate")
        pad_h = F.pad(v_p, (r, r, 0, 0), mode="replicate")
        kv, kh = taps[:, None, :, None], taps[:, None, None, :]
        t = dict(
            v=time_ms(lambda: blur.blur_v(base, host)),
            v_plain=time_ms(lambda: blur.blur_v_plain(base, taps)),
            v_library=time_ms(lambda: F.conv2d(pad_v, kv)),
            h=time_ms(lambda: blur.blur_h(v_p, taps)),
            h_plain=time_ms(lambda: blur.blur_h_plain(v_p, taps)),
            h_library=time_ms(lambda: F.conv2d(pad_h, kh, groups=C)),
        )
        t["v_bound"], t["v_bound_by"] = roofline.bound(
            *roofline.blur_v_work(*BLUR_SHAPE, C, T), "fp32")
        t["h_bound"], t["h_bound_by"] = roofline.bound(
            *roofline.blur_h_work(*BLUR_SHAPE, C, T), "fp32")
        log(f"[blur] {name} at {BLUR_SHAPE}: err v {err_v:.3g} h {err_h:.3g} "
            f"both {full:.3g} | v {t['v']:.4f} ms (bound {t['v_bound']:.4f}, "
            f"plain {t['v_plain']:.3f}, conv2d {t['v_library']:.3f}) "
            f"h {t['h']:.4f} ms (bound {t['h_bound']:.4f}, plain "
            f"{t['h_plain']:.3f}, conv2d {t['h_library']:.3f})")
        rows.append((name, err_v, err_h, t))
    return rows


def match_bank(dev):
    """base + 0.35 noise descriptors, unit rows (the repo bench's
    _match_bank recipe); 16 pairs of neighbouring images."""
    rng = np.random.default_rng(11)
    base = rng.standard_normal((MATCH_CAP, 128)).astype(np.float32)
    descs = []
    for _ in range(MATCH_IMAGES):
        d = base + 0.35 * rng.standard_normal(base.shape).astype(np.float32)
        d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)
        descs.append(d)
    bank = torch.from_numpy(np.stack(descs)).to(dev, torch.bfloat16)
    mask = torch.ones((MATCH_IMAGES, MATCH_CAP), dtype=torch.bool, device=dev)
    pairs = torch.tensor([[i, (i + 1) % MATCH_IMAGES] for i in range(MATCH_IMAGES)],
                         dtype=torch.int32, device=dev)
    return bank, mask, pairs


def check_matcher_ties(dev):
    """Exact ties and a fully masked image: descriptors drawn from 12 rows
    with entries in {-1, 0, 1} / 8, so every similarity is exact in f32 in
    any order of summation; the statistics must equal the plain ones."""
    from monocularsfm_torch.ops import match_kernel

    rng = np.random.default_rng(3)
    cap = 1024
    atoms = rng.integers(-1, 2, size=(12, 128)).astype(np.float32) / 8
    bank = torch.from_numpy(atoms[rng.integers(0, 12, size=(4, cap))]).to(
        dev, torch.bfloat16)
    mask = torch.from_numpy(rng.random((4, cap)) < 0.9).to(dev)
    mask[2] = False
    pairs = torch.tensor([[0, 1], [2, 1], [1, 2], [3, 3]], dtype=torch.int32,
                         device=dev)
    sk = match_kernel.match_stats(bank, mask, pairs)
    sp = match_kernel.match_stats_plain_batch(bank, mask, pairs)
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(sk, sp)]
    log(f"[match] exact ties + fully masked image, cap {cap}: statistics "
        f"equal to plain {same}")
    if not all(same):
        fail(f"matcher tie/mask case differs from the plain statistics: {same}")


def check_matcher(dev):
    from monocularsfm_torch.ops import match_kernel
    from monocularsfm_torch.ops.matching import match_pairs_batch
    from monocularsfm_torch.utils import roofline

    check_matcher_ties(dev)
    bank, mask, pairs = match_bank(dev)
    sk = match_kernel.match_stats(bank, mask, pairs)
    sp = match_kernel.match_stats_plain_batch(bank, mask, pairs)
    sim_err = max((a - b).abs().max().item()
                  for a, b in zip(sk, sp) if a.dtype == torch.float32)
    arg_agree = min((sk[i] == sp[i]).float().mean().item() for i in (1, 4))
    idx_k = match_pairs_batch(bank, mask, pairs)
    idx_p = match_pairs_batch(bank, mask, pairs, kernel=False)
    agree = (idx_k == idx_p).float().mean().item()
    matched = (idx_k >= 0).float().mean().item()
    log(f"[match] cap {MATCH_CAP}, {len(pairs)} pairs: sim err {sim_err:.3g}, "
        f"argmax agreement {arg_agree:.6f}, idx agreement {agree:.6f}, "
        f"matched share {matched:.3f}")
    if not (agree >= MATCH_AGREE and arg_agree >= MATCH_AGREE
            and sim_err <= SIM_TOL and matched > 0.5):
        fail(f"matcher disagrees: idx agreement {agree}, argmax agreement "
             f"{arg_agree} (need {MATCH_AGREE}), sim err {sim_err} (tol "
             f"{SIM_TOL}), matched share {matched}")
    A, B = bank[pairs[:, 0].long()], bank[pairs[:, 1].long()]
    rows, cols = match_kernel.match_tile_partials(bank, mask, pairs)
    t = dict(
        kernel=time_ms(lambda: match_kernel.launch(bank, mask, pairs, rows, cols), 10),
        whole=time_ms(lambda: match_kernel.match_stats(bank, mask, pairs), 10),
        plain=time_ms(lambda: match_kernel.match_stats_plain_batch(bank, mask, pairs), 3),
        library=time_ms(lambda: torch.bmm(A, B.transpose(1, 2)), 10),
    )
    nbytes, ops = roofline.match_work(mask.sum(1).tolist(), pairs.tolist(), MATCH_CAP)
    t["bound"], t["bound_by"] = roofline.bound(nbytes, ops, "bf16")
    log(f"[match] kernel {t['kernel']:.4f} ms ({ops / t['kernel'] / 1e9:.1f} "
        f"TFLOP/s bf16), match_stats whole (checks, kernel, merge) "
        f"{t['whole']:.4f} ms, bound "
        f"{t['bound']:.4f} ms ({t['bound_by']}), plain {t['plain']:.3f} ms, "
        f"bf16 bmm of the product alone {t['library']:.3f} ms, for "
        f"{len(pairs)} pairs")
    return sim_err, agree, t


def phase_sift(dev):
    from monocularsfm_torch.ops.sift import SIFT
    from monocularsfm_torch.utils.synthetic import render_textured_images

    img = render_textured_images(num_cameras=1, width=SIFT_SIZE[1],
                                 height=SIFT_SIZE[0], scene_seed=3)[0][0]
    t0 = time.perf_counter()
    kc, dc = SIFT(device="cpu").extract(img)
    t1 = time.perf_counter()
    kg, dg = SIFT(device=dev).extract(img)
    t2 = time.perf_counter()
    if len(kc) < 500 or len(kg) < 500:
        fail(f"SIFT found {len(kc)} (cpu) / {len(kg)} (cuda) keypoints")
    dxy = np.abs(kc[:, None, :2] - kg[None, :, :2]).max(-1)
    dang = np.abs((kc[:, None, 3] - kg[None, :, 3] + 180.0) % 360.0 - 180.0)
    cost = dxy + (dang > 0.5) * 1e3
    j = cost.argmin(1)
    paired = cost[np.arange(len(kc)), j] < KP_TOL
    share = paired.mean()
    derr = np.abs(dc[paired] - dg[j[paired]]).max()
    log(f"[sift] {SIFT_SIZE[1]}x{SIFT_SIZE[0]}: {len(kc)} cpu / {len(kg)} cuda "
        f"keypoints, {share:.4f} paired within {KP_TOL} px, descriptor err "
        f"{derr:.3g} | cpu {t1 - t0:.1f}s, cuda (cold) {t2 - t1:.2f}s")
    if share < KP_AGREE or derr > DESC_TOL:
        fail(f"SIFT cuda vs cpu: paired {share} (need {KP_AGREE}), "
             f"descriptor err {derr} (tol {DESC_TOL})")


def _plane_homography(K, R, t, a, b):
    """Homography of the world plane z=0 from camera a to camera b."""
    Rab = R[b] @ R[a].T
    tab = t[b] - Rab @ t[a]
    n_c = R[a] @ np.array([0.0, 0.0, 1.0])
    d_c = abs(float(np.array([0.0, 0.0, 1.0]) @ (-R[a].T @ t[a])))
    return K @ (Rab + np.outer(tab, n_c) / d_c) @ np.linalg.inv(K)


def phase_slice(dev):
    from monocularsfm_torch import cli
    from monocularsfm_torch.config import SfMConfig
    from monocularsfm_torch.database import Database
    from monocularsfm_torch.features.extraction import FeatureExtractor
    from monocularsfm_torch.ops import blur, match_kernel
    from monocularsfm_torch.utils.png import write_png
    from monocularsfm_torch.utils.synthetic import render_textured_images

    t0 = time.perf_counter()
    imgs, K, R, t = render_textured_images(
        num_cameras=SLICE_IMAGES, width=SLICE_W, height=SLICE_H, scene_seed=5)
    log(f"[slice] rendered {SLICE_IMAGES} images {SLICE_W}x{SLICE_H} in "
        f"{time.perf_counter() - t0:.1f}s")
    quiet = lambda *a: None  # noqa: E731
    with tempfile.TemporaryDirectory() as tmp:
        images = os.path.join(tmp, "images")
        os.makedirs(images)
        for i, im in enumerate(imgs):
            write_png(f"{images}/view{i:02d}.png", im)

        def run(db_name):
            cfg = SfMConfig(images_path=images, database_path=f"{tmp}/{db_name}")
            torch.cuda.synchronize()
            a = time.perf_counter()
            n_img = cli.cmd_extract(cfg, device=dev, log=quiet)
            torch.cuda.synchronize()
            b = time.perf_counter()
            n_pairs = cli.cmd_match(cfg, device=dev, log=quiet)
            torch.cuda.synchronize()
            c = time.perf_counter()
            return cfg, n_img, n_pairs, b - a, c - b

        run("warm.db")  # first-call costs: CUDA context, cuDNN, allocator
        blur.reset_launches()
        match_kernel.reset_launches()
        cfg, n_img, n_pairs, t_ext, t_match = run("slice.db")
        launches = dict(blur.LAUNCHES, **match_kernel.LAUNCHES)
        counts = cli.cmd_check_matches(cfg, log=quiet)

        db = Database(cfg.database_path)
        try:
            ids = sorted(db.read_all_images())
            kps = {i: db.read_keypoints(i) for i in ids}
            descs = {i: db.read_descriptors(i) for i in ids}
            matches = db.read_all_matches()
        finally:
            db.close()

    fe = FeatureExtractor(cfg.extraction, device=dev)
    batches = math.ceil(SLICE_IMAGES / fe.eff_batch_size(SLICE_H, SLICE_W))
    octaves = fe._get_sift().num_octaves(SLICE_H, SLICE_W)
    per_pass = batches * (1 + octaves)
    log(f"[slice] extract {n_img} images in {t_ext:.3f}s -> "
        f"{n_img / t_ext:.3f} images/s | match {n_pairs} pairs in "
        f"{t_match:.3f}s -> {n_pairs / t_match:.3f} pairs/s")
    log(f"[slice] launches {launches}; expected blur passes "
        f"{batches} batches x (1 + {octaves} octaves) = {per_pass} each")
    if n_img != SLICE_IMAGES or len(ids) != SLICE_IMAGES:
        fail(f"extracted {n_img} of {SLICE_IMAGES} images")
    for i in ids:
        k, d = kps[i], descs[i]
        if len(k) < MIN_KEYPOINTS or not np.isfinite(k).all() or not np.isfinite(d).all():
            fail(f"image {i}: {len(k)} keypoints, finite {np.isfinite(k).all()}")
        if k.shape[1] != 4 or d.shape != (len(k), 128):
            fail(f"image {i}: shapes {k.shape} {d.shape}")
        if np.abs(np.linalg.norm(d, axis=1) - 1.0).max() > 3e-3:
            fail(f"image {i}: descriptors are not unit length")
    if n_pairs != SLICE_IMAGES * (SLICE_IMAGES - 1) // 2:
        fail(f"matched {n_pairs} pairs")
    for a, b in zip(ids[:-1], ids[1:]):
        m = matches.get((a, b), np.zeros((0, 2)))
        if len(m) < MIN_VERIFIED:
            fail(f"adjacent pair ({a},{b}) has {len(m)} verified matches")
        # Verified matches must follow the rendered plane's homography.
        H = _plane_homography(K, R, t, a - ids[0], b - ids[0])
        p1 = np.c_[kps[a][m[:, 0], :2], np.ones(len(m))] @ H.T
        err = np.linalg.norm(p1[:, :2] / p1[:, 2:] - kps[b][m[:, 1], :2], axis=1)
        if (err < 3.0).mean() < 0.8:
            fail(f"pair ({a},{b}): {(err < 3.0).mean():.3f} of matches within "
                 f"3 px of the true homography")
    if counts != {p: len(m) for p, m in matches.items()}:
        fail("check-matches disagrees with the database")
    if not (launches["blur_v"] == launches["blur_h"] == per_pass):
        fail(f"blur launches {launches}, expected {per_pass} per pass")
    if launches["match_tile"] < 1:
        fail("the matcher kernel was not launched by the match stage")
    adj = [len(matches[(a, b)]) for a, b in zip(ids[:-1], ids[1:])]
    log(f"[slice] verified matches of adjacent pairs: {adj}")
    return launches, n_img / t_ext, n_pairs / t_match


def ring_problem(cams, points, track, seed, row_width=None):
    """The repo bench's camera-ring BA problem (bench.py _ring_problem),
    built with the port; with `row_width` every track is split into rows of
    that width (sorted point_rows, the PCG solver's cached path)."""
    from monocularsfm_torch.geometry import angle_axis_to_matrix
    from monocularsfm_torch.optim import make_bundle_problem
    from monocularsfm_torch.utils.synthetic import camera_ring_scene

    scene = camera_ring_scene(num_cameras=cams, num_points=points,
                              noise_px=0.5, seed=seed)
    rng = np.random.default_rng(0)
    vis = scene.visible.T
    keys = rng.random(vis.shape) + np.where(vis, 0.0, 10.0)
    order = np.argpartition(keys, min(track, vis.shape[1] - 1), axis=1)
    obs_cam = order[:, :track].astype(np.int32)
    obs_valid = np.take_along_axis(vis, order[:, :track], axis=1)
    obs_uv = scene.observations[obs_cam, np.arange(points)[:, None]]
    aa = torch.from_numpy(rng.normal(scale=0.01, size=(cams, 3))).float()
    R = np.einsum("cij,cjk->cik", angle_axis_to_matrix(aa).double().numpy(),
                  scene.R)
    t = scene.t + rng.normal(scale=0.02, size=(cams, 3))
    X = scene.points + rng.normal(scale=0.02, size=scene.points.shape)
    K4 = [scene.K[0, 0], scene.K[1, 1], scene.K[0, 2], scene.K[1, 2]]
    const = np.arange(cams) == 0
    nobs = int(obs_valid.sum())
    if row_width is None:
        return make_bundle_problem(K4, R, t, X, obs_cam, obs_uv, obs_valid,
                                   const), nobs
    nrow = -(-track // row_width)
    return make_bundle_problem(
        K4, R, t, X, obs_cam.reshape(-1, row_width),
        obs_uv.reshape(-1, row_width, 2), obs_valid.reshape(-1, row_width),
        const, point_valid=obs_valid.any(1),
        point_rows=np.repeat(np.arange(points), nrow)), nobs


def timed_ba(prob, dev, **kw):
    """(result, wall seconds) of one bundle_adjust on `dev`."""
    from monocularsfm_torch.optim import bundle_adjust

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = bundle_adjust(prob, device=dev, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_ba_dense(dev):
    from monocularsfm_torch.optim import bundle_adjust

    t0 = time.perf_counter()
    prob, nobs = ring_problem(BA_CAMS, BA_POINTS, BA_TRACK, seed=2)
    gpu = prob.to(dev)
    log(f"[ba_dense] {BA_CAMS} cams, {BA_POINTS} points, {nobs} obs "
        f"(built in {time.perf_counter() - t0:.1f}s)")
    timed_ba(gpu, dev, max_iterations=2)            # first-call costs
    out, dt = timed_ba(gpu, dev, max_iterations=BA_ITERS, **FIXED_WORK)
    it = out["iterations"]
    c0, c1 = float(out["cost_initial"]), float(out["cost_final"])
    rmse = float(out["rmse_final"])
    log(f"[ba_dense] {it} LM iters in {dt:.3f}s -> {it / dt:.3f} iters/s | "
        f"cost {c0:.1f} -> {c1:.1f}, rmse {float(out['rmse_initial']):.4f} -> "
        f"{rmse:.5f} px, mean reproj {float(out['mean_reproj_error']):.5f} px")
    if not (c1 < c0 and rmse <= RMSE_MAX):
        fail(f"dense BA: cost {c0} -> {c1}, rmse_final {rmse} (need <= {RMSE_MAX})")
    rel = 0.0
    for k in (1, 2, 3):
        a = float(bundle_adjust(prob, device="cpu", max_iterations=k)["cost_final"])
        b = float(bundle_adjust(gpu, device=dev, max_iterations=k)["cost_final"])
        rel = max(rel, abs(a - b) / a)
        log(f"[ba_dense] after {k} LM iters: cost cpu {a:.4f} cuda {b:.4f}")
    if rel > CUDA_CPU_RTOL:
        fail(f"dense BA cuda vs cpu: relative cost difference {rel} > {CUDA_CPU_RTOL}")
    return {"ba_dense_lm_iters_per_s": it / dt, "ba_dense_lm_iters": it,
            "ba_dense_rmse_final": rmse, "ba_dense_cuda_cpu_cost_rel": rel}


def phase_ba_pcg(dev, dense_rmse):
    t0 = time.perf_counter()
    prob, nobs = ring_problem(PCG_CAMS, PCG_POINTS, PCG_TRACK, seed=3, row_width=3)
    gpu = prob.to(dev)
    del prob
    log(f"[ba_pcg] {PCG_CAMS} cams, {PCG_POINTS} points, {nobs} obs in rows "
        f"of 3 (built in {time.perf_counter() - t0:.1f}s)")
    kw = dict(solve_mode="pcg", pcg_iters=PCG_INNER)
    timed_ba(gpu, dev, max_iterations=1, **kw)      # first-call costs
    out, dt = timed_ba(gpu, dev, max_iterations=PCG_LM_ITERS, **kw, **FIXED_WORK)
    it, cg = out["iterations"], out["cg_steps"]
    rmse = float(out["rmse_final"])
    log(f"[ba_pcg] {it} LM iters, {cg} CG steps in {dt:.3f}s -> "
        f"{it / dt:.3f} iters/s | rmse {float(out['rmse_initial']):.4f} -> "
        f"{rmse:.5f} px")
    if rmse > RMSE_MAX:
        fail(f"PCG BA: rmse_final {rmse} > {RMSE_MAX}")
    del gpu
    split, _ = ring_problem(BA_CAMS, BA_POINTS, BA_TRACK, seed=2, row_width=4)
    same, dt2 = timed_ba(split.to(dev), dev, max_iterations=BA_ITERS, **kw)
    diff = abs(float(same["rmse_final"]) - dense_rmse)
    log(f"[ba_pcg] {BA_CAMS}-camera problem by PCG: {same['iterations']} LM "
        f"iters, {same['cg_steps']} CG steps in {dt2:.3f}s, rmse "
        f"{float(same['rmse_final']):.5f} px vs dense {dense_rmse:.5f} (diff {diff:.2e})")
    if diff > PCG_DENSE_TOL:
        fail(f"PCG vs dense rmse_final differ by {diff} px > {PCG_DENSE_TOL}")
    return {"ba_pcg_lm_iters_per_s": it / dt, "ba_pcg_lm_iters": it,
            "ba_pcg_cg_steps": cg, "ba_pcg_rmse_final": rmse,
            "ba_pcg_vs_dense_rmse_diff": diff}


def phase_reconstruct(dev, views):
    from monocularsfm_torch import cli, native
    from monocularsfm_torch.config import SfMConfig
    from monocularsfm_torch.io.colmap import read_colmap
    from monocularsfm_torch.io.openmvs import read_openmvs_summary
    from monocularsfm_torch.io.ply import read_ply
    from monocularsfm_torch.ops import blur, match_kernel
    from monocularsfm_torch.utils.png import write_png
    from monocularsfm_torch.utils.synthetic import (
        render_multiplane_images,
        similarity_align,
    )

    t0 = time.perf_counter()
    imgs, K, R_gt, t_gt = render_multiplane_images(
        scene_seed=MP_SEED, num_cameras=views, width=MP_W, height=MP_H,
        arc_deg=MP_ARC_PER_VIEW * views)
    log(f"[pipeline] rendered {views} views {MP_W}x{MP_H} in "
        f"{time.perf_counter() - t0:.1f}s")
    quiet = lambda *a: None  # noqa: E731
    with tempfile.TemporaryDirectory() as tmp:
        images = os.path.join(tmp, "images")
        os.makedirs(images)
        for i, im in enumerate(imgs):
            write_png(f"{images}/frame{i:04d}.png", im)
        cfg = SfMConfig(images_path=images, database_path=f"{tmp}/mp.db",
                        output_path=f"{tmp}/out")
        cfg.camera.fx, cfg.camera.fy = float(K[0, 0]), float(K[1, 1])
        cfg.camera.cx, cfg.camera.cy = float(K[0, 2]), float(K[1, 2])
        cfg.extraction.num_features = 8024
        cfg.matching.match_type = "sequential"
        cfg.matching.overlap = 12
        stages = {}

        def stage(name, fn, *a, **kw):
            torch.cuda.synchronize()
            a0 = time.perf_counter()
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            stages[name] = time.perf_counter() - a0
            log(f"[pipeline] {name}: {stages[name]:.2f}s")
            return res

        blur.reset_launches()
        match_kernel.reset_launches()
        stage("extract", cli.cmd_extract, cfg, device=dev, log=quiet)
        n_pairs = stage("match", cli.cmd_match, cfg, device=dev, log=quiet)
        builder = stage("reconstruct", cli.cmd_reconstruct, cfg, device=dev,
                        log=log)
        launches = dict(blur.LAUNCHES, **match_kernel.LAUNCHES)
        if builder.map._native is None:
            fail("the native track-maintenance library is not loaded")
        log(f"[pipeline] native library loaded: {native.library_path().name}")
        st = builder.map.statistics()
        out = os.path.join(tmp, "out")
        model = read_colmap(os.path.join(out, "colmap"))
        mvs = read_openmvs_summary(os.path.join(out, "scene.mvs"))
        ply_xyz, _ = read_ply(os.path.join(out, "cloud_binary.ply"))
        ids = {builder.map.images[i].name: i for i in builder.map.registered_ids}
        src, dst = [], []
        for v in range(views):
            i = ids.get(f"frame{v:04d}.png")
            if i is not None:
                im = builder.map.images[i]
                src.append(-im.R.T @ im.t)
                dst.append(-R_gt[v].T @ t_gt[v])
    _, rms = similarity_align(np.asarray(src), np.asarray(dst))
    center_pct = 100.0 * rms / float(np.linalg.norm(np.ptp(np.asarray(dst), axis=0)))
    timers = {k: builder.timers[k].elapsed for k in (
        "initialize", "register", "triangulate", "local_ba", "global_ba",
        "filter", "total")}
    log(f"[pipeline] {st.num_registered_images}/{views} registered, "
        f"{st.num_points3D} points, {st.num_observations} obs, mean reproj "
        f"{st.mean_reprojection_error:.5f} px, camera-centre RMS "
        f"{center_pct:.5f}% of the scene diagonal, {n_pairs} pairs matched")
    log(f"[pipeline] MapBuilder timers (s): "
        + ", ".join(f"{k} {v:.2f}" for k, v in timers.items()))
    log(f"[pipeline] launches {launches}")
    if st.num_registered_images < views - 1:
        fail(f"registered {st.num_registered_images} of {views} views")
    if not st.mean_reprojection_error < MP_REPROJ_MAX:
        fail(f"mean reprojection error {st.mean_reprojection_error} px")
    if not center_pct < MP_CENTER_PCT_MAX:
        fail(f"camera-centre RMS {center_pct}% of the scene diagonal")
    if not st.num_points3D > MP_MIN_POINTS:
        fail(f"{st.num_points3D} points (need > {MP_MIN_POINTS})")
    if (sorted(model["images"]) != sorted(builder.map.registered_ids)
            or len(model["points"]) != st.num_points3D
            or len(ply_xyz) != st.num_points3D
            or mvs["images"] != views
            or mvs["posed_images"] != st.num_registered_images):
        fail(f"exports disagree with the map: COLMAP {len(model['images'])} "
             f"images / {len(model['points'])} points, PLY {len(ply_xyz)}, "
             f"mvs {mvs}")
    if not (launches["blur_v"] > 0 and launches["blur_h"] > 0
            and launches["match_tile"] > 0):
        fail(f"pipeline kernel launches {launches}")
    return launches, {
        "pipeline_views": views,
        "pipeline_registered": st.num_registered_images,
        "pipeline_points": st.num_points3D,
        "pipeline_mean_reproj_px": st.mean_reprojection_error,
        "pipeline_center_rms_pct_of_scene": center_pct,
        "pipeline_stage_s": stages,
        "pipeline_mapbuilder_s": timers,
    }


def main():
    dev = "cuda"
    smi = phase_device()
    import monocularsfm_torch  # noqa: F401  (precision pins)

    phase_build()
    blur_rows = check_blur(dev)
    sim_err, agree, tm = check_matcher(dev)
    phase_sift(dev)
    launches_slice, ips, pps = phase_slice(dev)
    walls = {}

    def walled(name, fn, *a):
        t0 = time.perf_counter()
        res = fn(*a)
        walls[name] = time.perf_counter() - t0
        log(f"[{name}] phase wall {walls[name]:.1f}s")
        return res

    rates = walled("ba_dense", phase_ba_dense, dev)
    rates.update(walled("ba_pcg", phase_ba_pcg, dev, rates["ba_dense_rmse_final"]))
    launches, quality = walled("pipeline", phase_reconstruct, dev, MP_VIEWS)
    rates.update(quality, phase_wall_s=walls)

    _, err_v, err_h, t = blur_rows[1]  # the octave stack dominates
    base_t = blur_rows[0][3]

    def entry(name, source, line, err, ms, plain, bound, by, library, **extra):
        return {"name": name, "route": "cuda",
                "source": f"monocularsfm_torch/csrc/{source}",
                "replaces": f"monocularsfm_tpu/ops/{line}",
                "launches": launches[name],
                "launches_extract_match": launches_slice[name],
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bound, "bound_by": by,
                "bound_share": bound / ms, "library_ms": library, **extra}

    kernels = [
        entry("blur_v", "blur.cu", "pallas_blur.py:42", err_v, t["v"],
              t["v_plain"], t["v_bound"], t["v_bound_by"], t["v_library"],
              base_c1_t9={k: base_t[k] for k in ("v", "v_plain", "v_bound",
                                                 "v_library")}),
        entry("blur_h", "blur.cu", "pallas_blur.py:59", err_h, t["h"],
              t["h_plain"], t["h_bound"], t["h_bound_by"], t["h_library"],
              base_c1_t9={k: base_t[k] for k in ("h", "h_plain", "h_bound",
                                                 "h_library")}),
        entry("match_tile", "match_tile.cu", "pallas_matching.py:39", sim_err,
              tm["kernel"], tm["plain"], tm["bound"], tm["bound_by"],
              tm["library"], index_agreement=agree,
              match_stats_whole_ms=tm["whole"],
              library_is="bf16 torch.bmm of the product alone, not the same function",
              shape={"pairs": MATCH_IMAGES, "capacity": MATCH_CAP}),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels, "extract_images_per_s": ips,
                      "match_pairs_per_s": pps, **rates}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
