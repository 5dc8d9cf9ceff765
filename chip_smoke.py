"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from monocularsfm_torch/csrc, checks each against its
plain PyTorch version on the card, checks the port's SIFT on the card
against the same SIFT on the CPU, then drives the port's extract and match
stages (`sfm-torch extract`, `match`, `check-matches`) on 8 rendered
1280x960 images at the default configuration.  It stops at the first
failure with a non-zero exit.  The last three lines of standard output are
the card's name and power limit (nvidia-smi), one JSON object describing
the kernels, and {"ok": true, "device": {...}}.  Logs go to stderr.
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
MATCH_CAP, MATCH_IMAGES = 8192, 8
MATCH_AGREE = 0.999
SIM_TOL = 1e-4                  # f32 sums of 128 bf16 products, any order
SIFT_SIZE = (480, 640)
KP_TOL, DESC_TOL, KP_AGREE = 0.01, 2e-3, 0.99
SLICE_IMAGES, SLICE_W, SLICE_H = 8, 1280, 960
MIN_VERIFIED = 15
MIN_KEYPOINTS = 1000            # per 1280x960 view (about 8000 expected)


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


def check_blur(dev):
    from monocularsfm_torch.ops import blur
    from monocularsfm_torch.ops.sift import _OCT_KER, gaussian_kernel1d, SIGMA0, INIT_SIGMA

    g = torch.Generator(dev).manual_seed(SEED)
    base = torch.rand(BLUR_SHAPE, generator=g, device=dev)
    kb = gaussian_kernel1d(math.sqrt(SIGMA0 ** 2 - 4.0 * INIT_SIGMA ** 2))
    rows = []
    for name, taps_np in (("base C=1 T=9", kb[None]), ("octave C=5 T=31", _OCT_KER)):
        taps = torch.as_tensor(taps_np, device=dev)
        v_k, v_p = blur.blur_v(base, taps), blur.blur_v_plain(base, taps)
        h_k, h_p = blur.blur_h(v_p, taps), blur.blur_h_plain(v_p, taps)
        full = (blur.blur_multi(base, taps)
                - blur.blur_multi_plain(base, taps)).abs().max().item()
        err_v = (v_k - v_p).abs().max().item()
        err_h = (h_k - h_p).abs().max().item()
        if not (err_v <= BLUR_TOL and err_h <= BLUR_TOL and full <= BLUR_TOL):
            fail(f"blur {name}: max abs err v {err_v} h {err_h} both {full} "
                 f"> {BLUR_TOL}")
        t = dict(
            v=time_ms(lambda: blur.blur_v(base, taps)),
            v_plain=time_ms(lambda: blur.blur_v_plain(base, taps)),
            h=time_ms(lambda: blur.blur_h(v_p, taps)),
            h_plain=time_ms(lambda: blur.blur_h_plain(v_p, taps)),
        )
        log(f"[blur] {name} at {BLUR_SHAPE}: err v {err_v:.3g} h {err_h:.3g} "
            f"both {full:.3g} | v {t['v']:.3f} ms (plain {t['v_plain']:.3f}) "
            f"h {t['h']:.3f} ms (plain {t['h_plain']:.3f})")
        rows.append((name, err_v, err_h, t))
    return rows


def match_bank(dev):
    """base + 0.35 noise descriptors, unit rows (the repo bench's
    _match_bank recipe)."""
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


def check_matcher(dev):
    from monocularsfm_torch.ops import match_kernel
    from monocularsfm_torch.ops.matching import match_pairs_batch

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
    if not (agree >= MATCH_AGREE and sim_err <= SIM_TOL and matched > 0.5):
        fail(f"matcher disagrees: idx agreement {agree} (need {MATCH_AGREE}), "
             f"sim err {sim_err} (tol {SIM_TOL}), matched share {matched}")
    t_k = time_ms(lambda: match_kernel.match_tile_partials(bank, mask, pairs), 5)
    t_p = time_ms(lambda: match_kernel.match_stats_plain_batch(bank, mask, pairs), 3)
    flops = 2.0 * len(pairs) * MATCH_CAP * MATCH_CAP * 128
    log(f"[match] kernel {t_k:.3f} ms ({flops / t_k / 1e9:.1f} TFLOP/s fp32 FMA) "
        f"| plain {t_p:.3f} ms for {len(pairs)} pairs")
    return sim_err, agree, t_k, t_p


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


def main():
    dev = "cuda"
    smi = phase_device()
    import monocularsfm_torch  # noqa: F401  (precision pins)

    phase_build()
    blur_rows = check_blur(dev)
    sim_err, agree, t_k, t_p = check_matcher(dev)
    phase_sift(dev)
    launches, ips, pps = phase_slice(dev)

    _, err_v, err_h, t = blur_rows[1]  # the octave stack dominates
    kernels = [
        {"name": "blur_v", "route": "cuda",
         "source": "monocularsfm_torch/csrc/blur.cu",
         "replaces": "monocularsfm_tpu/ops/pallas_blur.py:42",
         "launches": launches["blur_v"], "max_abs_err": err_v,
         "ms": t["v"], "plain_ms": t["v_plain"]},
        {"name": "blur_h", "route": "cuda",
         "source": "monocularsfm_torch/csrc/blur.cu",
         "replaces": "monocularsfm_tpu/ops/pallas_blur.py:59",
         "launches": launches["blur_h"], "max_abs_err": err_h,
         "ms": t["h"], "plain_ms": t["h_plain"]},
        {"name": "match_tile", "route": "cuda",
         "source": "monocularsfm_torch/csrc/match_tile.cu",
         "replaces": "monocularsfm_tpu/ops/pallas_matching.py:39",
         "launches": launches["match_tile"], "max_abs_err": sim_err,
         "index_agreement": agree, "ms": t_k, "plain_ms": t_p},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels, "extract_images_per_s": ips,
                      "match_pairs_per_s": pps}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
