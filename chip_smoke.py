"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from monocularsfm_torch/csrc, checks each against its
plain PyTorch version on the card at the main path's shapes (the fused
blur also bit for bit against the two single passes; the matcher over 16
pairs at capacity 8192, plus a case of exact ties and a fully masked
image that must equal the plain statistics), times each beside its
plain version, the bound of its work and one library call of the same
function where there is one, checks the port's SIFT on the card
against the same SIFT on the CPU, then drives the port's extract and match
stages (`sfm-torch extract`, `match`, `check-matches`) on 8 rendered
1280x960 images at the default configuration.  Then bundle adjustment on
the card: the dense Schur solver on a 128-camera / 40k-point ring (against
the same solve on the CPU) and the PCG solver on a 1024-camera /
200k-point ring with split tracks.  Then `sfm-torch pipeline` (extract,
match, reconstruct, export) on 24 rendered 1280x960 views of a
multi-plane scene, checked against the true poses.  Then a second
pipeline on 16 of those views as a camera with lens distortion records
them, with vocabulary retrieval, P3P registration, the event log, profiler
traces and the undistorted-image export; last the PnP solvers (p3p, ap3p,
p6p, upnp) on the card against the CPU with the same draws.  It stops at the first failure with a non-zero exit.  The last three lines of standard output are
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
# Pipeline: tools/scale_run.py's recipe at 24 views (mp128 camera spacing;
# 32 until the smoke gained its PnP and alternate-pipeline phases).
MP_VIEWS, MP_W, MP_H, MP_SEED = 24, 1280, 960, 7
MP_ARC_PER_VIEW = 200.0 / 128
MP_REPROJ_MAX, MP_CENTER_PCT_MAX, MP_MIN_POINTS = 0.5, 0.1, 5000
# PnP: every minimal solver on one ring view, card against CPU with the same
# draws, at RegistrantConfig's 4096 hypotheses and the capacity of an 8024-
# feature image (8192).  UPnP is given a K whose focal is 8% off.
PNP_METHODS = ("p3p", "ap3p", "p6p", "upnp")
PNP_HYPS, PNP_CAP, PNP_POINTS, PNP_OUTLIERS = 4096, 8192, 11_000, 0.3
PNP_AGREE, PNP_POSE_TOL = 0.999, 1e-3
# UPnP does not refine the focal: the winner is the hypothesis with the
# most inliers and the least truncated error, and at the same inlier count
# hypotheses whose focal differs by about 1% (their depth compensating)
# score within f32 rounding of each other.  So the card and the CPU may
# keep different ones: held to the same inliers (1%, masks 99%), the
# rotation, and each device's focal within 2% of the truth.
UPNP_FOCAL_SCALE, UPNP_FOCAL, UPNP_COUNT, UPNP_AGREE = 1.08, 0.02, 0.01, 0.99
# The alternate pipeline: 16 distorted views of the mp scene, vocabulary
# retrieval, P3P registration, the event log and the profiler traces.
ALT_VIEWS, ALT_MIN_REG, ALT_NEIGHBORS = 16, 15, 6
ALT_DIST = [-0.08, 0.012, 4e-4, -6e-4]   # tests/test_distortion_pipeline.py
ALT_GREY_MAX, ALT_MARGIN = 3.0, 48       # mean |undistorted - pinhole|, interior


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
    """Each blur kernel against its plain version at the octave-0 shape,
    both (C, T); the fused kernel also bit for bit against the single
    passes; each timed beside its bound, its plain version and one library
    call of the same function (F.conv2d on the replicate-padded input, TF32
    off by the package's precision pins)."""
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
        h_k, h_p = blur.blur_h(v_p, host), blur.blur_h_plain(v_p, taps)
        vh_k, vh_p = blur.blur_vh(base, host), blur.blur_multi_plain(base, taps)
        pair_equal = torch.equal(vh_k, blur.blur_h(v_k, host))
        C, T = taps.shape
        r = (T - 1) // 2
        pad_v = F.pad(base[:, None], (0, 0, r, r), mode="replicate")
        pad_h = F.pad(v_p, (r, r, 0, 0), mode="replicate")
        pad_2d = F.pad(base[:, None], (r, r, r, r), mode="replicate")
        kv, kh = taps[:, None, :, None], taps[:, None, None, :]
        k2d = (taps[:, :, None] * taps[:, None, :])[:, None]   # (C, 1, T, T)
        err = dict(v=(v_k - v_p).abs().max().item(),
                   h=(h_k - h_p).abs().max().item(),
                   vh=(vh_k - vh_p).abs().max().item(),
                   vh_library=(F.conv2d(pad_2d, k2d) - vh_p).abs().max().item())
        del v_k, h_k, h_p, vh_k, vh_p
        if not (max(err["v"], err["h"], err["vh"]) <= BLUR_TOL and pair_equal):
            fail(f"blur {name}: max abs err {err} (tol {BLUR_TOL}), fused "
                 f"equal to blur_h(blur_v(x)): {pair_equal}")
        t = dict(
            v=time_ms(lambda: blur.blur_v(base, host)),
            v_plain=time_ms(lambda: blur.blur_v_plain(base, taps)),
            v_library=time_ms(lambda: F.conv2d(pad_v, kv)),
            h=time_ms(lambda: blur.blur_h(v_p, host)),
            h_plain=time_ms(lambda: blur.blur_h_plain(v_p, taps)),
            h_library=time_ms(lambda: F.conv2d(pad_h, kh, groups=C)),
            vh=time_ms(lambda: blur.blur_vh(base, host)),
            vh_plain=time_ms(lambda: blur.blur_multi_plain(base, taps)),
            vh_library=time_ms(lambda: F.conv2d(pad_2d, k2d)),
            pair=time_ms(lambda: blur.blur_h(blur.blur_v(base, host), host)),
        )
        for k, work in (("v", roofline.blur_v_work), ("h", roofline.blur_h_work),
                        ("vh", roofline.blur_multi_work)):
            t[f"{k}_bound"], t[f"{k}_bound_by"] = roofline.bound(
                *work(*BLUR_SHAPE, C, T), "fp32")
        log(f"[blur] {name} at {BLUR_SHAPE}: err {err}, fused equal to the "
            f"pair: {pair_equal}")
        for k in ("v", "h", "vh"):
            log(f"[blur]   {k} {t[k]:.4f} ms (bound {t[f'{k}_bound']:.4f} "
                f"{t[f'{k}_bound_by']}, plain {t[f'{k}_plain']:.3f}, conv2d "
                f"{t[f'{k}_library']:.3f})")
        log(f"[blur]   the pair blur_h(blur_v(x)) {t['pair']:.4f} ms")
        rows.append((name, err, pair_equal, t))
        del v_p, pad_v, pad_h, pad_2d
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
    log(f"[slice] launches {launches}; expected fused blur launches "
        f"{batches} batches x (1 + {octaves} octaves) = {per_pass}")
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
    if not (launches["blur_vh"] == per_pass
            and launches["blur_v"] == launches["blur_h"] == 0):
        fail(f"blur launches {launches}, expected blur_vh {per_pass} times "
             f"and no single pass")
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
    if not (launches["blur_vh"] > 0 and launches["match_tile"] > 0):
        fail(f"pipeline kernel launches {launches}")
    return (imgs, K, R_gt, t_gt), launches, {
        "pipeline_views": views,
        "pipeline_registered": st.num_registered_images,
        "pipeline_points": st.num_points3D,
        "pipeline_mean_reproj_px": st.mean_reprojection_error,
        "pipeline_center_rms_pct_of_scene": center_pct,
        "pipeline_stage_s": stages,
        "pipeline_mapbuilder_s": timers,
    }


def pnp_inputs(dev):
    """Camera 2 of a three-camera ring, 0.5 px noise, 30% outliers, padded to
    PNP_CAP; the draws of one registration round, made on the host so the
    card and the CPU get the same ones."""
    from monocularsfm_torch.utils.synthetic import camera_ring_scene

    scene = camera_ring_scene(num_cameras=3, num_points=PNP_POINTS, noise_px=0.5,
                              seed=SEED)
    rng = np.random.default_rng(SEED)
    vis = np.nonzero(scene.visible[2])[0][:PNP_CAP]
    uv = scene.observations[2][vis].copy()
    bad = rng.random(len(uv)) < PNP_OUTLIERS
    uv[bad] = rng.uniform(0, [scene.width, scene.height], (bad.sum(), 2))
    X = np.zeros((PNP_CAP, 3), np.float32)
    U = np.zeros((PNP_CAP, 2), np.float32)
    m = np.zeros(PNP_CAP, bool)
    X[:len(vis)], U[:len(vis)], m[:len(vis)] = scene.points[vis], uv, True
    u = torch.rand((PNP_HYPS, PNP_CAP), generator=torch.Generator().manual_seed(SEED))
    host = [torch.from_numpy(a) for a in (X, U, m)]
    return scene, u, host, [a.to(dev) for a in host]


def phase_pnp(dev):
    """estimate_pnp_ransac with p3p, ap3p, p6p and upnp on the card and on
    the CPU with the same draws: the same winner after the polish (inlier
    count, masks, pose; UPnP: see UPNP_*), p3p equal to ap3p bit for bit on
    the card, and each method's hypotheses/s on the card (one registration
    round, polish included)."""
    from monocularsfm_torch.estimators.pnp import estimate_pnp_ransac

    scene, u, host, card = pnp_inputs(dev)
    u_dev = u.to(dev)
    n_valid = int(host[2].sum())
    out, rates = {}, {}
    for method in PNP_METHODS:
        K = scene.K.astype(np.float32)
        if method == "upnp":
            K[[0, 1], [0, 1]] *= UPNP_FOCAL_SCALE
        K = torch.from_numpy(K)
        K_dev = K.to(dev)
        t0 = time.perf_counter()
        c = estimate_pnp_ransac(u, K, *host, method=method)
        t_cpu = time.perf_counter() - t0
        g = estimate_pnp_ransac(u_dev, K_dev, *card, method=method)
        ms = time_ms(lambda: estimate_pnp_ransac(u_dev, K_dev, *card, method=method), 3)
        g = {k: v.cpu() for k, v in g.items()}
        n_c, n_g = int(c["num_inliers"]), int(g["num_inliers"])
        agree = (c["inliers"] == g["inliers"]).float().mean().item()
        dR = (c["R"] - g["R"]).abs().max().item()
        dt = (c["t"] - g["t"]).abs().max().item()
        f_c, f_g = float(c["focal"]), float(g["focal"])
        truth = float(np.abs(g["R"].double().numpy() - scene.R[2]).max())
        rates[method] = {
            "hypotheses_per_s": PNP_HYPS / (ms / 1e3), "ms": ms, "cpu_s": t_cpu,
            "inliers_cuda": n_g, "inliers_cpu": n_c, "mask_agreement": agree,
            "R_diff": dR, "t_diff": dt, "focal_cuda": f_g, "focal_cpu": f_c,
            "R_err_vs_truth": truth}
        log(f"[pnp] {method}: {PNP_HYPS} hypotheses x {PNP_CAP} capacity "
            f"({n_valid} valid) in {ms:.3f} ms -> {PNP_HYPS / (ms / 1e3):.0f} "
            f"hypotheses/s (cpu {t_cpu:.2f}s) | inliers cuda {n_g} cpu {n_c}, "
            f"mask agreement {agree:.6f}, |dR| {dR:.2e}, |dt| {dt:.2e}, focal "
            f"cuda {f_g:.3f} cpu {f_c:.3f} (true {scene.K[0, 0]}), R vs truth "
            f"{truth:.2e}")
        if method == "upnp":
            ok = (abs(n_g - n_c) <= UPNP_COUNT * n_c and agree >= UPNP_AGREE
                  and dR <= PNP_POSE_TOL
                  and max(abs(f / scene.K[0, 0] - 1.0) for f in (f_c, f_g)) <= UPNP_FOCAL)
        else:
            ok = (n_g == n_c and agree >= PNP_AGREE and max(dR, dt) <= PNP_POSE_TOL
                  and f_g == f_c)
        if not (ok and n_g >= 0.5 * n_valid and truth < 0.01):
            fail(f"pnp {method}: card vs cpu {rates[method]}")
        out[method] = g
    same = all(torch.equal(out["p3p"][k], out["ap3p"][k]) for k in ("R", "t", "inliers"))
    log(f"[pnp] p3p equal to ap3p bit for bit on the card: {same}")
    if not same:
        fail("p3p and ap3p differ on the card")
    return rates


def distorted_renders(imgs, K, dev):
    """Each pinhole render sampled at the undistorted position of every
    pixel of a camera with ALT_DIST (bicubic, on the card): the views that
    camera would record."""
    import torch.nn.functional as F

    from monocularsfm_torch.ops.undistort import undistort_pixels

    n, H, W = imgs.shape
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev),
                          indexing="ij")
    und = undistort_pixels(torch.stack([u, v], -1), K, ALT_DIST)
    grid = torch.stack([2 * und[..., 0] / (W - 1) - 1, 2 * und[..., 1] / (H - 1) - 1], -1)
    out = F.grid_sample(torch.from_numpy(imgs).to(dev).float()[:, None],
                        grid[None].expand(n, H, W, 2), mode="bicubic",
                        padding_mode="border", align_corners=True)
    return torch.clamp(torch.round(out[:, 0]), 0, 255).to(torch.uint8).cpu().numpy()


def _trace_kernels(path):
    """Names of the device kernels in a Chrome trace of torch.profiler."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e.get("name", "") for e in events if e.get("cat") == "kernel"}


def alt_config(dimgs, K, root, profile_dir=""):
    """Write the distorted views as PNGs under `root` and the alternate
    pipeline's config: the main pipeline's, plus ALT_DIST, vocabulary
    retrieval with ALT_NEIGHBORS partners, P3P registration."""
    from monocularsfm_torch.config import SfMConfig
    from monocularsfm_torch.utils.png import write_png

    images = os.path.join(root, "images")
    os.makedirs(images)
    for i, im in enumerate(dimgs):
        write_png(f"{images}/frame{i:04d}.png", im)
    cfg = SfMConfig(images_path=images, database_path=f"{root}/alt.db",
                    output_path=f"{root}/out")
    cfg.camera.fx, cfg.camera.fy = float(K[0, 0]), float(K[1, 1])
    cfg.camera.cx, cfg.camera.cy = float(K[0, 2]), float(K[1, 2])
    cfg.camera.k1, cfg.camera.k2, cfg.camera.p1, cfg.camera.p2 = ALT_DIST
    cfg.extraction.num_features = 8024
    cfg.matching.match_type = "vocab"
    cfg.matching.vocab_num_neighbors = ALT_NEIGHBORS
    cfg.registrant.pnp_method = "p3p"
    cfg.map_builder.profile_dir = profile_dir
    return cfg


def _stage(stages, name, fn, *a, **kw):
    torch.cuda.synchronize()
    a0 = time.perf_counter()
    res = fn(*a, **kw)
    torch.cuda.synchronize()
    stages[name] = time.perf_counter() - a0
    log(f"[pipeline_alt] {name}: {stages[name]:.2f}s")
    return res


def profiled_alt_run(dimgs, K, dev):
    """The alternate config on the first half of the views with the
    profilers on: extract + match under torch.profiler (by this script) and
    the build's `profile_dir`.  Returns (kernel names in each trace, stage
    walls, registered)."""
    from torch.profiler import ProfilerActivity, profile

    from monocularsfm_torch import cli

    quiet = lambda *a: None  # noqa: E731
    stages = {}
    with tempfile.TemporaryDirectory() as tmp:
        prof_dir = os.path.join(tmp, "profile")
        cfg = alt_config(dimgs, K, tmp, profile_dir=prof_dir)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _stage(stages, "profiled extract", cli.cmd_extract, cfg, device=dev, log=quiet)
            _stage(stages, "profiled match", cli.cmd_match, cfg, device=dev, log=quiet)
        t0 = time.perf_counter()
        os.makedirs(prof_dir)
        prof.export_chrome_trace(os.path.join(prof_dir, "stages_trace.json"))
        stages["stage trace export"] = time.perf_counter() - t0
        builder = _stage(stages, "profiled reconstruct", cli.cmd_reconstruct, cfg,
                         device=dev, log=quiet)
        kernels = {name: _trace_kernels(os.path.join(prof_dir, f"{name}_trace.json"))
                   for name in ("stages", "mapbuilder")}
    return kernels, stages, builder.map.statistics().num_registered_images


def phase_pipeline_alt(dev, renders):
    """`sfm-torch` extract, match, reconstruct and export of the first
    ALT_VIEWS of the main pipeline's renders (`renders`: images, K, R, t),
    recorded by a camera with ALT_DIST, with vocabulary retrieval, P3P
    registration and the event log; then the same on half the views with
    the profilers on (profiling the 16-view build took the phase past
    90 s)."""
    from monocularsfm_torch import cli
    from monocularsfm_torch.database import Database
    from monocularsfm_torch.ops import blur, match_kernel
    from monocularsfm_torch.utils.png import read_png
    from monocularsfm_torch.utils.synthetic import similarity_align

    t0 = time.perf_counter()
    imgs, K, R_gt, t_gt = renders
    imgs, R_gt, t_gt = imgs[:ALT_VIEWS], R_gt[:ALT_VIEWS], t_gt[:ALT_VIEWS]
    dimgs = distorted_renders(imgs, K, dev)
    log(f"[pipeline_alt] distorted {ALT_VIEWS} views {MP_W}x{MP_H} in "
        f"{time.perf_counter() - t0:.1f}s")
    quiet = lambda *a: None  # noqa: E731
    stages = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = alt_config(dimgs, K, tmp)
        metrics = os.path.join(tmp, "events.jsonl")
        blur.reset_launches()
        match_kernel.reset_launches()
        _stage(stages, "extract", cli.cmd_extract, cfg, device=dev, log=quiet)
        _stage(stages, "match", cli.cmd_match, cfg, device=dev, log=log)
        builder = _stage(stages, "reconstruct", cli.cmd_reconstruct, cfg, device=dev,
                         log=quiet, metrics_path=metrics)
        launches = dict(blur.LAUNCHES, **match_kernel.LAUNCHES)
        db = Database(cfg.database_path)
        try:
            retrieved = len(db.read_all_matches())
        finally:
            db.close()
        st = builder.map.statistics()
        und_dir = os.path.join(tmp, "out", "undistorted_images")
        und_names = sorted(os.listdir(und_dir))
        m = ALT_MARGIN
        grey = [float(np.abs(read_png(os.path.join(und_dir, f"frame{v:04d}.png"))[..., 0].astype(int)
                             - imgs[v].astype(int))[m:-m, m:-m].mean())
                for v in range(ALT_VIEWS)]
        with open(metrics) as f:
            events = [json.loads(line) for line in f]
        ids = {builder.map.images[i].name: i for i in builder.map.registered_ids}
        src, dst = [], []
        for v in range(ALT_VIEWS):
            i = ids.get(f"frame{v:04d}.png")
            if i is not None:
                im = builder.map.images[i]
                src.append(-im.R.T @ im.t)
                dst.append(-R_gt[v].T @ t_gt[v])
    half = ALT_VIEWS // 2
    kernels, prof_stages, prof_reg = profiled_alt_run(dimgs[:half], K, dev)
    stages.update(prof_stages)
    _, rms = similarity_align(np.asarray(src), np.asarray(dst))
    center_pct = 100.0 * rms / float(np.linalg.norm(np.ptp(np.asarray(dst), axis=0)))
    timers = {k: builder.timers[k].elapsed for k in (
        "initialize", "register", "triangulate", "local_ba", "global_ba",
        "filter", "total")}
    n_reg = st.num_registered_images
    n_register = sum(e["event"] == "register" for e in events)
    n_gba = sum(e["event"] == "global_ba" for e in events)
    named = sorted(n for n in kernels["stages"] if "blur_vh" in n or "match_tile" in n)
    exhaustive = ALT_VIEWS * (ALT_VIEWS - 1) // 2
    log(f"[pipeline_alt] {n_reg}/{ALT_VIEWS} registered, {st.num_points3D} points, "
        f"mean reproj {st.mean_reprojection_error:.5f} px, camera-centre RMS "
        f"{center_pct:.5f}% of the scene diagonal, retrieval kept {retrieved} "
        f"of {exhaustive} pairs")
    log("[pipeline_alt] MapBuilder timers (s): "
        + ", ".join(f"{k} {v:.2f}" for k, v in timers.items()))
    log(f"[pipeline_alt] launches {launches}; events: {n_register} register, "
        f"{n_gba} global_ba; undistorted images {len(und_names)}, interior "
        f"mean |undistorted - pinhole| max {max(grey):.3f} grey levels")
    log(f"[pipeline_alt] profiled {half}-view run: {prof_reg}/{half} registered; "
        f"kernels named in the extract + match trace: {named}; the build's "
        f"trace: {len(kernels['mapbuilder'])} distinct kernels")
    if n_reg < ALT_MIN_REG or prof_reg < half - 1:
        fail(f"alt pipeline registered {n_reg} of {ALT_VIEWS} views, the "
             f"profiled run {prof_reg} of {half}")
    if not st.mean_reprojection_error < MP_REPROJ_MAX:
        fail(f"alt pipeline mean reprojection error {st.mean_reprojection_error} px")
    if not center_pct < MP_CENTER_PCT_MAX:
        fail(f"alt pipeline camera-centre RMS {center_pct}% of the scene diagonal")
    if not (launches["match_tile"] > 0 and launches["blur_vh"] > 0):
        fail(f"alt pipeline kernel launches {launches}")
    if not retrieved < exhaustive:
        fail(f"retrieval kept {retrieved} pairs, exhaustive matching {exhaustive}")
    if len(und_names) != ALT_VIEWS or max(grey) >= ALT_GREY_MAX:
        fail(f"undistorted_images: {len(und_names)} files, interior grey "
             f"differences {grey} (need < {ALT_GREY_MAX})")
    if n_register != n_reg - 2 or n_gba < 1:
        fail(f"event log: {n_register} register events for {n_reg} registered "
             f"images, {n_gba} global_ba events")
    if not (any("blur_vh" in n for n in named) and any("match_tile" in n for n in named)
            and kernels["mapbuilder"]):
        fail(f"profiler traces: stage kernels {sorted(kernels['stages'])[:20]}, "
             f"build kernels {len(kernels['mapbuilder'])}")
    return launches, {
        "views": ALT_VIEWS, "registered": n_reg, "points": st.num_points3D,
        "mean_reproj_px": st.mean_reprojection_error,
        "center_rms_pct_of_scene": center_pct, "retrieved_pairs": retrieved,
        "exhaustive_pairs": exhaustive, "undistorted_grey_mean_max": max(grey),
        "register_events": n_register, "global_ba_events": n_gba,
        "profiled_views": half, "profiled_registered": prof_reg,
        "stage_s": stages, "mapbuilder_s": timers,
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
    renders, launches, quality = walled("pipeline", phase_reconstruct, dev, MP_VIEWS)
    rates.update(quality)
    launches_alt, rates["pipeline_alt"] = walled("pipeline_alt", phase_pipeline_alt,
                                                 dev, renders)
    del renders
    rates["pnp"] = walled("pnp", phase_pnp, dev)
    rates["phase_wall_s"] = walls

    _, err, pair_equal, t = blur_rows[1]  # the octave stack dominates
    _, base_err, base_equal, base_t = blur_rows[0]

    def entry(name, source, line, err, ms, plain, bound, by, library, **extra):
        return {"name": name, "route": "cuda",
                "source": f"monocularsfm_torch/csrc/{source}",
                "replaces": f"monocularsfm_tpu/ops/{line}",
                "launches": launches[name],
                "launches_extract_match": launches_slice[name],
                "launches_pipeline_alt": launches_alt[name],
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bound, "bound_by": by,
                "bound_share": bound / ms, "library_ms": library, **extra}

    def blur_entry(k, name, line, **extra):
        base_keys = (k, f"{k}_plain", f"{k}_bound", f"{k}_library")
        return entry(name, "blur.cu", line, err[k], t[k], t[f"{k}_plain"],
                     t[f"{k}_bound"], t[f"{k}_bound_by"], t[f"{k}_library"],
                     base_c1_t9={**{key: base_t[key] for key in base_keys},
                                 "max_abs_err": base_err[k]}, **extra)

    kernels = [
        blur_entry("v", "blur_v", "pallas_blur.py:42"),
        blur_entry("h", "blur_h", "pallas_blur.py:59"),
        blur_entry("vh", "blur_vh", "pallas_blur.py:59",
                   fuses="monocularsfm_tpu/ops/pallas_blur.py:42",
                   equal_to_pair={"C=5 T=31": pair_equal, "C=1 T=9": base_equal},
                   pair_ms={"C=5 T=31": t["pair"], "C=1 T=9": base_t["pair"]},
                   library_is="F.conv2d, (C, 1, T, T) outer-product weights",
                   library_max_abs_err=err["vh_library"]),
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
