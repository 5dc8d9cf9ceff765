"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from monocularsfm_torch/csrc, checks each against its
plain PyTorch version on the card at the main path's shapes (the fused
blur also bit for bit against the two single passes; the matcher over 16
pairs at capacity 8192, plus a case of exact ties and a fully masked
image that must equal the plain statistics; the Schur product of bundle
adjustment's PCG path at the neu.global-ba bundle's shapes, also twice bit
for bit), times each beside its plain version, the bound of its work and
one library call of the same function where there is one, checks the
port's SIFT on the card
against the same SIFT on the CPU, then drives the port's extract and match
stages (`sfm-torch extract`, `match`, `check-matches`) on 8 rendered
1280x960 images at the default configuration.  Then bundle adjustment on
the card: the dense Schur solver on a 128-camera / 40k-point ring (against
the same solve on the CPU) and the PCG solver on a 1024-camera /
200k-point ring with split tracks.  Then the repo bench's path
(`phase_bench`): the single-pair matcher (kernel 3 one pair per launch)
against the plain matcher on the card, the entry point's solve on the
card against the CPU, and `bench_torch.run_all()` at full shape (dense
and PCG BA, SIFT on four 1280x960 renders, 64 single-pair matches), whose
four rates it prints on a line of their own, then the single-pair matcher
on five pairs of unequal capacities (8192 x 512 to 1024 x 512, one launch
each) against the plain matcher.  Then `sfm-torch pipeline` (extract,
match, reconstruct, export) on 56 rendered 1280x960 views of a
multi-plane scene, checked against the true poses, with dense and PCG
global bundle adjustments (the event log names each one's solver).  Then a second
pipeline on 16 of those views as a camera with lens distortion records
them, with vocabulary retrieval, P3P registration, the event log, profiler
traces and the undistorted-image export; then the PnP solvers (p3p, ap3p,
p6p, upnp) on the card against the CPU with the same draws; last the
shipped configs' image size: the fused blur at the octave-0 shape of a
3200x2400 image, that image's SIFT on the card against the CPU, and
`sfm-torch extract` of two 4000x3000 PNGs resized to 3200x2400.
Between the second pipeline and the PnP solvers, `phase_gather`: SIFT's
gather sampler (`sample_mode: gather`) on the slice's 1280x960 batch and
a 3200x2400 image (against the same sampler on the CPU and against the
patch sampler), the pipeline on 16 of the views in gather mode, and LM
in segments (`dispatch_iters`) and on shuffled split rows; then
`phase_repeat`: one input, two runs, the same bits, for dense and PCG BA,
the vocabulary trainer and a 16-view pipeline (it prints a {"repeat": ...}
line on standard output); then `phase_width`, the main path at its users'
widths on the card against the CPU: SIFT with the default settings on a
1280x960 render whose keypoints the 8024 cap cuts, in both samplers, and
the MapBuilder on the 16-view feature database, matched once on the card
and built on the card and on the CPU with the same draws made on the
host (the same registered images, events and solvers; points and camera
centres within stated tolerances).  Last
the multi-device layer (`phase_parallel`) on the one card: landmark-sharded
BA as a world of one NCCL rank in this process and as two gloo ranks
sharing the card (the dense and the scaling table's PCG ring, against the
unsharded solve), pair-sharded and ring matching over the two ranks
(against the single-device kernel's maps), the dry run, and `sfm-torch
match` + `reconstruct` under `torch.distributed.run` with two ranks on 16
of the pipeline's views.  It stops at the first failure with a non-zero
exit.  The last three lines of standard output are
the card's name and power limit (nvidia-smi), one JSON object describing
the kernels and the measured rates, and {"ok": true, "device": {...}}.
Logs go to stderr.
"""

from __future__ import annotations

import json
import math
import os
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
# The Schur product's kernel against its plain version: the largest
# difference over the largest entry; f32 sums of the same terms (about
# 2,000 a camera) in two orders.
SCHUR_RTOL = 1e-5
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
# Pipeline: tools/scale_run.py's recipe at 56 views (mp128 camera spacing),
# past config.py's dense_max_images of 50, so that global BA must take PCG
# on split track rows; on this scene the dense path's observation capacity
# (dense_max_obs) already sends it there from 25 views on.
MP_VIEWS, MP_W, MP_H, MP_SEED = 56, 1280, 960, 7
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
# The shipped configs' max_image_size: a 3200x2400 image (octave 0 at
# 6400x4800 after the 2x upsample, one image per batch), and two 4000x3000
# PNGs that the extraction stage resizes to it.
BIG_W, BIG_H, BIG_SEED = 3200, 2400, 11
BIG_SHAPE = (1, 2 * BIG_H, 2 * BIG_W)
# The card's and the CPU's f32 sums may settle a borderline candidate
# differently (5050 against 5049 keypoints, every one paired), so the
# counts are held within 1%, as tests/test_torch_sift.py holds them.
KP_COUNT_TOL = 0.01
HUGE_W, HUGE_H, HUGE_IMAGES = 4000, 3000, 2
# The multi-device layer on one card: a world of one NCCL rank, and two gloo
# ranks sharing the card (NCCL takes one rank per GPU).  Sharded BA is held
# to the unsharded solve on the same problem; the second ring is the
# scaling table's (tools/scaling_table_torch.py).
PAR_RMSE_TOL = 1e-3
PAR_PCG_CAMS, PAR_PCG_POINTS, PAR_PCG_TRACK = 256, 50_000, 6
PAR_MATCH_IMAGES = 8                 # 28 pairs of match_bank at capacity 8192
PAR_VIEWS, PAR_MIN_REG, PAR_DENSE_MAX = 16, 15, 8
PAR_TIMEOUT = 300.0
# The repo bench's measurements through bench_torch.py (phase_bench): kernel
# 3 one pair per launch on bench_torch's descriptor banks, and the entry
# point's solve on the card against the CPU.
BENCH_PAIRS = 4
ENTRY_RTOL = 1e-4
# The single-pair matcher on rectangular pairs (N_A, N_B): the first rows of
# two of bench_torch's banks, side A's mask 90% valid.  Where at least half
# of A's rows have their partner in B, at least RECT_MATCHED of them match.
RECT_SHAPES = ((8192, 512), (512, 8192), (8192, 4096), (4096, 8192), (1024, 512))
RECT_HALF_SHAPES = ((8192, 4096), (4096, 8192))
RECT_MATCHED = 0.3
# SIFT's gather sampler (sample_mode "gather", phase_gather): the slice's
# 4-image 1280x960 batch and one 3200x2400 image in both modes; gather
# against patch under the reference's rule (tests/test_sift.py): of the
# keypoints inside the descriptor's reach, GATHER_SHARED at least pair by
# (x, y, angle), their descriptors within GATHER_DESC_TOL.  Then the
# pipeline on the first GATHER_VIEWS of the main pipeline's renders.
GATHER_IMAGES, GATHER_VIEWS, GATHER_MIN_REG = 4, 16, 15
GATHER_SHARED, GATHER_DESC_TOL = 0.9, 5e-3
# Resumable LM: segments of SEG_DENSE_STEP / SEG_PCG_STEP iterations against
# one segment of the same fixed work, rmse_final within SEG_RTOL relative;
# the PCG ring's split rows shuffled against the sorted rows (which sums
# each camera's and point's rows in another order), within the same.
SEG_DENSE_ITERS, SEG_DENSE_STEP, SEG_PCG_STEP, SEG_RTOL = 12, 4, 3, 1e-4
# One input, two runs (phase_repeat): dense and PCG BA on the rings above,
# train_visual_vocab on the 16-view feature database, and the pipeline on
# the first REPEAT_VIEWS of the main pipeline's renders (global BA dense to
# REPEAT_DENSE_MAX views, PCG beyond), each run twice and held bit-equal.
REPEAT_VIEWS, REPEAT_DENSE_MAX, REPEAT_WORDS = 16, 8, 4096
# The main path at its users' widths, card against CPU (phase_width): SIFT
# at 1280x960 in both samplers on the first of the pipeline's renders (its
# keypoints pass the 8024 cap, which cuts them), then the MapBuilder on the
# WIDTH_VIEWS views of the 16-view database, matched once on the card and
# built on the card and on the CPU with the same draws, made on the host
# (HostDraws); global BA dense to WIDTH_DENSE_MAX views and PCG beyond.
# The card and the CPU sum in other orders (ROADMAP: "Card against CPU"), so
# the builds agree to tolerances: the same registered images, events and
# solvers, point counts within WIDTH_POINTS_RTOL, camera centres within
# WIDTH_CENTRE_PCT of the scene diagonal after a similarity alignment
# (measured on an H100: 12,699 against 12,718 points, 0.00047%).
WIDTH_VIEWS, WIDTH_DENSE_MAX = 16, 8
WIDTH_POINTS_RTOL, WIDTH_CENTRE_PCT = 0.005, 0.01
PAR_PROBLEMS = (   # (name, (cams, points, track, seed), solver arguments)
    ("dense", (BA_CAMS, BA_POINTS, BA_TRACK, 2),
     dict(max_iterations=BA_ITERS, **FIXED_WORK)),
    ("pcg", (PAR_PCG_CAMS, PAR_PCG_POINTS, PAR_PCG_TRACK, 3),
     dict(max_iterations=PCG_LM_ITERS, solve_mode="pcg", pcg_iters=PCG_INNER,
          **FIXED_WORK)),
)


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
    from monocularsfm_torch.utils.card import card_line

    line = card_line("cuda")
    print(line, flush=True)
    log(f"[device] {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | {line}")
    return line


def phase_build():
    from monocularsfm_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build()
    log(f"[build] {', '.join(p.name for p in paths)} in "
        f"{time.perf_counter() - t0:.2f}s "
        f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'})")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "C75" in line:
            log(f"[build] {line.strip()}")


def check_blur(dev, shape=BLUR_SHAPE):
    """Each blur kernel against its plain version at an octave-0 shape,
    both (C, T); the fused kernel also bit for bit against the single
    passes; each timed beside its bound, its plain version and one library
    call of the same function (F.conv2d on the replicate-padded input, TF32
    off by the package's precision pins)."""
    import torch.nn.functional as F

    from monocularsfm_torch.ops import blur
    from monocularsfm_torch.ops.sift import _OCT_KER, gaussian_kernel1d, SIGMA0, INIT_SIGMA
    from monocularsfm_torch.utils import roofline

    g = torch.Generator(dev).manual_seed(SEED)
    base = torch.rand(shape, generator=g, device=dev)
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
                *work(*shape, C, T), "fp32")
        log(f"[blur] {name} at {shape}: err {err}, fused equal to the "
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


def schur_inputs(dev):
    """The Schur product's inputs at the neu.global-ba bundle's shapes: its
    observations as the solver selects them (sfmbench's make_problem: 1,329
    cameras in 2,048 slots, 542,084 points in 2**20, 2,710,444
    observations), random blocks of the solver's kinds (W, the inverses of
    symmetric positive definite V and U_d, x), and the plan."""
    from monocularsfm_torch.config import BundleConfig
    from monocularsfm_torch.ops import schur
    from monocularsfm_torch.utils.segment import segment_plan
    from sfmbench.lib.common import camera_of
    from sfmbench.stages.global_ba import make_problem

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "sfmbench", "configs", "neu.json")) as f:
        config = json.load(f)
    ba = dict(config["ba"], track_width=BundleConfig().track_width)
    prob = make_problem(ba, camera_of(config), dev)[0]
    T = prob["obs_cam"].shape[1]
    C, P = prob["R"].shape[0], prob["X"].shape[0]
    pt_all = prob["point_rows"][:, None].expand(-1, T).reshape(-1)
    cam_all = prob["obs_cam"].reshape(-1)
    obs = (prob["obs_valid"].reshape(-1) & prob["point_valid"][pt_all]
           & prob["cam_valid"][cam_all]).nonzero()[:, 0]
    cam_o, pt_o = cam_all[obs], pt_all[obs]
    del prob, obs
    g = torch.Generator(device=dev).manual_seed(SEED)
    n = cam_o.numel()
    W = torch.randn((n, 6, 3), generator=g, device=dev)
    A = torch.randn((P, 3, 3), generator=g, device=dev)
    Vi = torch.linalg.inv(A @ A.transpose(1, 2)
                          + torch.eye(3, device=dev)).contiguous()
    B = torch.randn((C, 6, 6), generator=g, device=dev)
    U = B @ B.transpose(1, 2) + 6 * torch.eye(6, device=dev)
    x = torch.randn((C, 6), generator=g, device=dev)
    plan = schur.schur_plan(segment_plan(cam_o, C), segment_plan(pt_o, P))
    return W, Vi, x, U, plan, int(torch.unique(pt_o).numel())


def check_schur(dev):
    """The Schur product's kernel pair (csrc/schur.cu) at the neu.global-ba
    shapes: against the plain version on the card, twice bit for bit, the
    launch counter, then timed beside its byte bound and the plain
    version.  No single PyTorch call computes the product: no library
    time.  Prints ptxas's registers and spills of the two passes (from the
    build's log beside the library)."""
    from monocularsfm_torch.ops import _build, schur
    from monocularsfm_torch.utils import roofline

    lines = _build.build(["schur"])[0].with_suffix(".log").read_text().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and ("points_pass" in line
                                                   or "cams_pass" in line):
            name = "points_pass" if "points_pass" in line else "cams_pass"
            used = [ln.strip() for ln in lines[i + 1:i + 4]
                    if "registers" in ln or "spill" in ln]
            log(f"[schur] ptxas {name}: {' | '.join(used)}")
    W, Vi, x, U, plan, points = schur_inputs(dev)
    n, C = W.shape[0], x.shape[0]
    schur.reset_launches()
    out = schur.schur_product(W, Vi, x, plan, U)
    again = schur.schur_product(W, Vi, x, plan, U)
    torch.cuda.synchronize()
    plain = schur.schur_product_plain(W, Vi, x, plan, U)
    err = (out - plain).abs().max().item() / plain.abs().max().item()
    equal = bits_equal(out, again)
    log(f"[schur] {n} observations, {points} points, {C} camera slots: "
        f"kernel vs plain {err:.3g} of the largest entry, two calls equal "
        f"{equal}, launches {schur.LAUNCHES}")
    if not (err <= SCHUR_RTOL and equal
            and schur.LAUNCHES == {"schur_points": 2, "schur_cams": 2}):
        fail(f"schur kernel: error {err} (tol {SCHUR_RTOL}), repeat equal "
             f"{equal}, launches {schur.LAUNCHES}")
    t = dict(kernel=time_ms(lambda: schur.schur_product(W, Vi, x, plan, U), 50),
             plain=time_ms(lambda: schur.schur_product_plain(W, Vi, x, plan, U), 10))
    nbytes, ops = roofline.schur_work(n, points, C, plan.order is not None)
    t["bound"], t["bound_by"] = roofline.bound(nbytes, ops, "fp32")
    log(f"[schur] kernel pair {t['kernel']:.4f} ms ({nbytes / t['kernel'] / 1e6:.0f} "
        f"GB/s of {nbytes / 1e6:.1f} MB), bound {t['bound']:.4f} ms "
        f"({t['bound_by']}, {100 * t['bound'] / t['kernel']:.1f}%), plain "
        f"{t['plain']:.4f} ms, library: none (no single PyTorch call)")
    return {"name": "schur_product", "route": "cuda",
            "source": "monocularsfm_torch/csrc/schur.cu",
            "replaces": None, "max_rel_err": err, "equal_twice": equal,
            "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": t["bound"],
            "bound_by": t["bound_by"], "bound_share": t["bound"] / t["kernel"],
            "library_ms": None,
            "library_is": "none: no single PyTorch call computes this product",
            "shape": {"observations": n, "points": points, "camera_slots": C}}


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
    from monocularsfm_torch.utils.ring_problem import ring_problem

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
    from monocularsfm_torch.utils.ring_problem import ring_problem

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
            "ba_pcg_vs_dense_rmse_diff": diff}, gpu


def _pair_unchecked(a, b, ma, mb, pair00):
    """match_descriptors_pair_auto without match_tile_partials' input checks
    (whose pair_ids range test waits for the card twice per call): the same
    two one-image banks, launch, merge and decision."""
    from monocularsfm_torch.ops import match_kernel
    from monocularsfm_torch.ops.matching import _decide

    A, B = a.to(torch.bfloat16)[None], b.to(torch.bfloat16)[None]
    N_a, N_b, G = A.shape[1], B.shape[1], A.shape[1] // match_kernel.TILE
    f32 = dict(device=A.device, dtype=torch.float32)
    i32 = dict(device=A.device, dtype=torch.int32)
    rows = (torch.empty((1, N_a), **f32), torch.empty((1, N_a), **i32),
            torch.empty((1, N_a), **f32))
    cols = (torch.empty((1, G, N_b), **f32), torch.empty((1, G, N_b), **i32),
            torch.empty((1, G, N_b), **f32))
    match_kernel.launch(A, ma[None], pair00, rows, cols, B, mb[None])
    stats = tuple(x[0] for x in rows + match_kernel._merge_partials(*cols))
    return _decide(ma, stats, 0.8, 0.7, True)


def check_rectangular(dev, descs, pair00):
    """The single-pair matcher at each of RECT_SHAPES on the card: one launch
    of kernel 3 per call, idx_b against the plain matcher, the six
    statistics against the plain ones, the unchecked call equal; then the
    kernel at P = 1 timed beside its bound, the plain statistics, the bf16
    product and the whole call.  Returns {"NAxNB": numbers}."""
    from monocularsfm_torch.ops import match_kernel
    from monocularsfm_torch.ops.matching import (
        match_descriptors_pair,
        match_descriptors_pair_auto,
    )
    from monocularsfm_torch.utils import roofline

    rng = np.random.default_rng(SEED)
    out = {}
    for n_a, n_b in RECT_SHAPES:
        a, b = descs[0][:n_a], descs[1][:n_b]
        ma = torch.from_numpy(rng.random(n_a) < 0.9).to(dev)
        mb = torch.ones(n_b, dtype=torch.bool, device=dev)
        match_kernel.reset_launches()
        k = match_descriptors_pair_auto(a, b, ma, mb)
        torch.cuda.synchronize()
        launches = match_kernel.LAUNCHES["match_tile"]
        p = match_descriptors_pair(a, b, ma, mb)
        sk = match_kernel.match_stats_pair(a, b, ma, mb)
        sp = match_kernel.match_stats_plain(a, b, ma, mb)
        r = dict(
            grid=[n_a // match_kernel.TILE, 1], tiles_per_cta=n_b // match_kernel.TILE,
            launches_per_call=launches,
            index_agreement=(k == p).float().mean().item(),
            matched_share=(k >= 0).float().mean().item(),
            max_abs_err=max((x - y).abs().max().item()
                            for x, y in zip(sk, sp) if x.dtype == torch.float32),
            argmax_agreement=min((sk[i] == sp[i]).float().mean().item() for i in (1, 4)),
            unchecked_equal=bool((_pair_unchecked(a, b, ma, mb, pair00) == k).all()))
        matched_min = RECT_MATCHED if (n_a, n_b) in RECT_HALF_SHAPES else 0.0
        if not (launches == 1 and r["index_agreement"] >= MATCH_AGREE
                and r["argmax_agreement"] >= MATCH_AGREE and r["max_abs_err"] <= SIM_TOL
                and r["matched_share"] > matched_min and r["unchecked_equal"]):
            fail(f"rectangular pair ({n_a}, {n_b}): {r} (need one launch, "
                 f"agreement >= {MATCH_AGREE}, sim err <= {SIM_TOL}, matched "
                 f"share > {matched_min}, the unchecked call equal)")
        A, B = a.to(torch.bfloat16)[None], b.to(torch.bfloat16)[None]
        ma1, mb1 = ma[None], mb[None]
        rows, cols = match_kernel.match_tile_partials(A, ma1, pair00, B, mb1)
        r.update(
            ms=time_ms(lambda: match_kernel.launch(A, ma1, pair00, rows, cols, B, mb1), 20),
            plain_ms=time_ms(lambda: match_kernel.match_stats_plain(a, b, ma, mb), 3),
            library_ms=time_ms(lambda: A[0] @ B[0].T, 20),
            call_ms=time_ms(lambda: match_descriptors_pair_auto(a, b, ma, mb), 20))
        nbytes, ops = roofline.match_work([int(ma.sum()), n_b], [(0, 1)], n_a, N_b=n_b)
        r["bound_ms"], r["bound_by"] = roofline.bound(nbytes, ops, "bf16")
        r["bound_share"] = r["bound_ms"] / r["ms"]
        log(f"[bench] (e) ({n_a}, {n_b}): kernel {r['ms']:.4f} ms (grid "
            f"{r['grid'][0]} x 1, {r['tiles_per_cta']} B tiles per CTA), bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']}, share {r['bound_share']:.3f}), "
            f"plain {r['plain_ms']:.3f} ms, bf16 mm of the product alone (not the "
            f"same function) {r['library_ms']:.4f} ms, whole call "
            f"{r['call_ms']:.4f} ms; idx agreement {r['index_agreement']:.6f}, "
            f"matched share {r['matched_share']:.3f}, sim err {r['max_abs_err']:.3g}, "
            f"argmax agreement {r['argmax_agreement']:.6f}, launches {launches}")
        out[f"{n_a}x{n_b}"] = r
    out["library_is"] = "bf16 torch.mm of the one product, not the same function"
    return out


def phase_bench(dev):
    """The repo bench's path through the port: (a) the single-pair matcher
    (kernel 3 at P = 1) against the plain matcher on the card on BENCH_PAIRS
    pairs of bench_torch's banks at capacity 8192, and its six statistics
    against the plain ones; (b) `entry("cuda")`'s solve against
    `entry("cpu")`'s; (c) `bench_torch.run_all()` at full shape on the
    card (no CPU baselines), its kernels counted; (d) kernel 3 at P = 1
    timed beside its bound, plain version and the bf16 product, and the
    whole call with and without the input checks' host waits; (e) the
    single-pair matcher on rectangular pairs (`check_rectangular`).  The
    square pair's statistics through one bank and through two one-image
    banks are equal bit for bit."""
    import bench_torch
    from monocularsfm_torch import entry as E
    from monocularsfm_torch.ops import blur, match_kernel
    from monocularsfm_torch.ops.matching import (
        match_descriptors_pair,
        match_descriptors_pair_auto,
    )
    from monocularsfm_torch.ops.sift import SIFT
    from monocularsfm_torch.utils import roofline

    if bench_torch.SMOKE or bench_torch.MATCH_CAP != MATCH_CAP:
        fail("BENCH_SMOKE is set: phase_bench runs the bench at full shape")
    descs = [torch.from_numpy(d).to(dev) for d in bench_torch._match_bank()]
    mask = torch.ones(MATCH_CAP, dtype=torch.bool, device=dev)
    agree, matched = [], []
    for r in range(BENCH_PAIRS):
        a, b = descs[r % 8], descs[(r + 1) % 8]
        k = match_descriptors_pair_auto(a, b, mask, mask)
        p = match_descriptors_pair(a, b, mask, mask)
        agree.append((k == p).float().mean().item())
        matched.append((k >= 0).float().mean().item())
    bank = torch.stack(descs[:2]).to(torch.bfloat16)
    mask2 = torch.ones((2, MATCH_CAP), dtype=torch.bool, device=dev)
    pair01 = torch.tensor([[0, 1]], dtype=torch.int32, device=dev)
    pair00 = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    sk = match_kernel.match_stats(bank, mask2, pair01)
    sp = match_kernel.match_stats_plain_batch(bank, mask2, pair01)
    sim_err = max((x - y).abs().max().item()
                  for x, y in zip(sk, sp) if x.dtype == torch.float32)
    arg_agree = min((sk[i] == sp[i]).float().mean().item() for i in (1, 4))
    same = (_pair_unchecked(descs[0], descs[1], mask, mask, pair00)
            == match_descriptors_pair_auto(descs[0], descs[1], mask, mask)).all().item()
    two_sided = match_kernel.match_stats_pair(descs[0], descs[1], mask, mask)
    bank_equal = all(torch.equal(x[0], y) for x, y in zip(sk, two_sided))
    log(f"[bench] (a) single pair, cap {MATCH_CAP}: idx agreement with plain "
        f"{agree}, matched share {matched}; statistics sim err {sim_err:.3g}, "
        f"argmax agreement {arg_agree:.6f}; unchecked call equal {same}; one "
        f"bank equal to two one-image banks {bank_equal}")
    if not (min(agree) >= MATCH_AGREE and arg_agree >= MATCH_AGREE
            and sim_err <= SIM_TOL and min(matched) > 0.5 and same and bank_equal):
        fail(f"single-pair matcher disagrees: idx agreement {agree}, argmax "
             f"agreement {arg_agree}, sim err {sim_err}, matched {matched}, "
             f"unchecked equal {same}, one bank equal to two {bank_equal}")

    fn, (prob,) = E.entry(dev)
    out = fn(prob)
    fn_c, (prob_c,) = E.entry("cpu")
    out_c = fn_c(prob_c)
    c_gpu, c_cpu = float(out["cost_final"]), float(out_c["cost_final"])
    entry_rel = abs(c_gpu - c_cpu) / c_cpu
    log(f"[bench] (b) entry: {out['iterations']} LM iters on {prob.R.device}, "
        f"rmse {float(out['rmse_initial']):.4f} -> {float(out['rmse_final']):.5f}"
        f" px, cost cuda {c_gpu:.6f} cpu {c_cpu:.6f} (rel {entry_rel:.2e})")
    if not (prob.R.device.type == torch.device(dev).type
            and out["iterations"] == out_c["iterations"]
            and float(out["rmse_final"]) < float(out["rmse_initial"])
            and entry_rel <= ENTRY_RTOL):
        fail(f"entry(): card cost {c_gpu} vs cpu {c_cpu} (rel {entry_rel}, tol "
             f"{ENTRY_RTOL}), iterations {out['iterations']} vs {out_c['iterations']}")

    blur.reset_launches()
    match_kernel.reset_launches()
    res = bench_torch.run_all(dev)
    torch.cuda.synchronize()
    launches = dict(blur.LAUNCHES, **match_kernel.LAUNCHES)
    octaves = SIFT(device=dev).num_octaves(bench_torch.EXTRACT_H, bench_torch.EXTRACT_W)
    want_vh = 4 * (1 + octaves)               # warm-up + 3 batches, base + octaves
    want_match = 1 + 64                       # warm-up + the timed calls
    rates = {"dense_lm_iters_per_s": res["dense_ips"],
             "pcg_lm_iters_per_s": res["pcg_ips"],
             "extract_images_per_s": res["extract_ips"],
             "match_pairs_per_s": res["match_pps"]}
    print(json.dumps({"bench_torch": rates}), flush=True)
    log(f"[bench] (c) run_all: {rates}; dense rmse {res['dense_rmse']:.5f}, "
        f"pcg rmse {res['pcg_rmse']:.5f} px, pcg est {res['pcg_gflops']:.1f} "
        f"GFLOP/s; launches {launches} (expected blur_vh {want_vh}, "
        f"match_tile {want_match})")
    if not (all(v > 0 for v in rates.values()) and res["dense_rmse"] <= RMSE_MAX
            and res["pcg_rmse"] <= RMSE_MAX):
        fail(f"bench: rates {rates}, rmse dense {res['dense_rmse']} pcg "
             f"{res['pcg_rmse']} (need <= {RMSE_MAX})")
    if not (launches["blur_vh"] == want_vh and launches["match_tile"] == want_match
            and launches["blur_v"] == launches["blur_h"] == 0):
        fail(f"bench launches {launches}, expected blur_vh {want_vh} and "
             f"match_tile {want_match}")

    rows, cols = match_kernel.match_tile_partials(bank, mask2, pair01)
    a, b = descs[0], descs[1]
    t = dict(
        ms=time_ms(lambda: match_kernel.launch(bank, mask2, pair01, rows, cols), 20),
        plain_ms=time_ms(lambda: match_kernel.match_stats_plain_batch(bank, mask2, pair01), 3),
        library_ms=time_ms(lambda: bank[0] @ bank[1].T, 20),
        auto_call_ms=time_ms(lambda: match_descriptors_pair_auto(a, b, mask, mask), 20),
        unchecked_call_ms=time_ms(lambda: _pair_unchecked(a, b, mask, mask, pair00), 20),
    )
    nbytes, ops = roofline.match_work([MATCH_CAP, MATCH_CAP], [(0, 1)], MATCH_CAP)
    t["bound_ms"], t["bound_by"] = roofline.bound(nbytes, ops, "bf16")
    t["bound_share"] = t["bound_ms"] / t["ms"]
    t["bench_ms_per_call"] = 1e3 / res["match_pps"]
    log(f"[bench] (d) kernel 3 at P = 1: {t['ms']:.4f} ms per launch (grid "
        f"{MATCH_CAP // match_kernel.TILE} x 1), bound {t['bound_ms']:.4f} ms "
        f"({t['bound_by']}), plain {t['plain_ms']:.3f} ms, bf16 mm of the "
        f"product {t['library_ms']:.4f} ms; match_descriptors_pair_auto "
        f"{t['auto_call_ms']:.4f} ms per call, without the input checks' host "
        f"waits {t['unchecked_call_ms']:.4f} ms; the bench loop "
        f"{t['bench_ms_per_call']:.4f} ms per call")
    single_pair = {
        "pairs": 1, "capacity": MATCH_CAP, "grid": [MATCH_CAP // match_kernel.TILE, 1],
        "max_abs_err": sim_err, "index_agreement": min(agree), **t,
        "library_is": "bf16 torch.mm of the one product, not the same function",
        "launches_bench": launches["match_tile"]}
    rectangular = check_rectangular(dev, descs, pair00)
    return launches, single_pair, rectangular, {
        **rates, "dense_rmse_final": res["dense_rmse"],
        "pcg_rmse_final": res["pcg_rmse"], "pcg_est_gflops": res["pcg_gflops"],
        "pcg_observations": res["pcg_obs"], "entry_cuda_cpu_cost_rel": entry_rel}


def copy_features(src, dst, names):
    """A database at `dst` with the images `names` of `src`: their
    keypoints, colours and descriptors, and no matches."""
    from monocularsfm_torch.database import Database

    a, b = Database(src), Database(dst)
    try:
        ids = {n: i for i, n in a.read_all_images().items()}
        for n in names:
            i, j = ids[n], b.write_image(n)
            b.write_keypoints(j, a.read_keypoints(i))
            b.write_descriptors(j, a.read_descriptors(i))
            colors = a.read_keypoints_color(i)
            if colors is not None:
                b.write_keypoints_color(j, colors)
    finally:
        a.close()
        b.close()


def phase_reconstruct(dev, views, keep_db=None):
    """The pipeline on `views` rendered views; with `keep_db`, the features
    of the first PAR_VIEWS views are copied to a database there."""
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

        metrics = os.path.join(tmp, "events.jsonl")
        blur.reset_launches()
        match_kernel.reset_launches()
        stage("extract", cli.cmd_extract, cfg, device=dev, log=quiet)
        n_pairs = stage("match", cli.cmd_match, cfg, device=dev, log=quiet)
        builder = stage("reconstruct", cli.cmd_reconstruct, cfg, device=dev,
                        log=log, metrics_path=metrics)
        launches = dict(blur.LAUNCHES, **match_kernel.LAUNCHES)
        if keep_db:
            copy_features(cfg.database_path, keep_db,
                          [f"frame{v:04d}.png" for v in range(PAR_VIEWS)])
        with open(metrics) as f:
            gba = [e for e in map(json.loads, f) if e["event"] == "global_ba"]
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
    pcg = [e for e in gba if e["solver"] == "pcg"]
    largest = max(pcg, key=lambda e: e["cams"], default=None)
    log(f"[pipeline] launches {launches}; global BAs (cams, solver): "
        f"{[(e['cams'], e['solver']) for e in gba]}")
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
    if views > cfg.bundle.dense_max_images and not pcg:
        fail(f"{views} views but no global BA ran PCG: {gba}")
    return (imgs, K, R_gt, t_gt), launches, {
        "pipeline_views": views,
        "pipeline_registered": st.num_registered_images,
        "pipeline_points": st.num_points3D,
        "pipeline_mean_reproj_px": st.mean_reprojection_error,
        "pipeline_center_rms_pct_of_scene": center_pct,
        "pipeline_stage_s": stages,
        "pipeline_mapbuilder_s": timers,
        "pipeline_reconstruct_outside_mapbuilder_s":
            stages["reconstruct"] - timers["total"],
        "pipeline_global_ba": {
            "dense": len(gba) - len(pcg), "pcg": len(pcg),
            "largest_pcg": (None if largest is None else
                            {k: largest[k] for k in ("cams", "iters", "rmse")})},
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


# One input, two runs (phase_repeat, tools/repeat_check.py): each helper
# runs one of the port's computations twice from the same inputs in this
# process and compares the two results bit for bit.  It reports whether
# every output is equal, the largest absolute difference, and the counts a
# user would see move (LM iterations, CG steps, registered images and
# points).

def bits_equal(a, b) -> bool:
    """True when two arrays have the same shape, dtype and bytes (so NaNs
    with the same payload compare equal, and -0.0 differs from 0.0)."""
    a, b = (torch.as_tensor(v).cpu().contiguous().reshape(-1) for v in (a, b))
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(torch.uint8), b.view(torch.uint8)))


def max_abs_diff(a, b) -> float:
    """The largest |a - b| over the entries finite in both; inf when the
    shapes differ, 0.0 for empty arrays."""
    a, b = (torch.as_tensor(v).cpu().double().reshape(-1) for v in (a, b))
    if a.shape != b.shape:
        return float("inf")
    both = torch.isfinite(a) & torch.isfinite(b)
    return float((a - b)[both].abs().max()) if bool(both.any()) else 0.0


def _twice(fn, device):
    """fn(0) and fn(1), each timed by the host clock around a synchronised
    run: ([result 0, result 1], [seconds 0, seconds 1])."""
    cuda = torch.device(device).type == "cuda"
    runs, walls = [], []
    for k in range(2):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs.append(fn(k))
        if cuda:
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return runs, walls


def ba_twice(prob, device, **kw) -> dict:
    """bundle_adjust twice on `prob` (already on `device`)."""
    from monocularsfm_torch.optim import bundle_adjust

    runs, walls = _twice(lambda _: bundle_adjust(prob, device=device, **kw), device)
    a, b = runs
    keys = ("R", "t", "X", "K", "cost_initial", "cost_final", "radius")
    equal = {k: bits_equal(a[k], b[k]) for k in keys}
    equal["iterations"] = a["iterations"] == b["iterations"]
    equal["cg_steps"] = a["cg_steps"] == b["cg_steps"]
    return {
        "equal": all(equal.values()), "equal_by_output": equal,
        "max_abs_diff": {k: max_abs_diff(a[k], b[k]) for k in ("R", "t", "X")},
        "cost_final": [float(r["cost_final"]) for r in runs],
        "rmse_final": [float(r["rmse_final"]) for r in runs],
        "lm_iterations": [r["iterations"] for r in runs],
        "cg_steps": [r["cg_steps"] for r in runs],
        "wall_s": walls,
    }


def descriptor_bank(database_path: str) -> np.ndarray:
    """Every image's descriptors in a database, stacked as unit f32 rows."""
    from monocularsfm_torch.database import Database

    db = Database(database_path)
    try:
        parts = [db.read_descriptors(i) for i in sorted(db.read_all_images())]
    finally:
        db.close()
    bank = np.concatenate([p for p in parts if p is not None]).astype(np.float32)
    return bank / np.maximum(np.linalg.norm(bank, axis=1, keepdims=True), 1e-12)


def vocab_twice(bank: np.ndarray, device, num_words: int = 4096) -> dict:
    """train_visual_vocab twice on a host bank of descriptors; where the
    two vocabularies differ, also the share of the bank's descriptors
    that the two assign to different words."""
    from monocularsfm_torch.ops.vocab import train_visual_vocab

    (a, b), walls = _twice(lambda _: train_visual_vocab(
        bank, num_words=num_words, device=device), device)
    equal = bits_equal(a, b)
    flipped = 0.0
    if not equal:
        d = torch.from_numpy(bank).to(a.device)
        flipped = float((torch.argmax(d @ a.T, 1)
                         != torch.argmax(d @ b.T, 1)).double().mean())
    return {"equal": equal, "max_abs_diff": max_abs_diff(a, b),
            "descriptors": len(bank), "num_words": num_words,
            "assignments_differing": flipped, "wall_s": walls}


def _run_pipeline(images: str, K, device, root: str, dense_max_images: int):
    """extract, match, reconstruct and export one database and output
    directory under `root`; returns what the comparison reads."""
    from monocularsfm_torch import cli
    from monocularsfm_torch.config import SfMConfig
    from monocularsfm_torch.database import Database

    cfg = SfMConfig(images_path=images, database_path=f"{root}.db",
                    output_path=root)
    cfg.camera.fx, cfg.camera.fy = float(K[0, 0]), float(K[1, 1])
    cfg.camera.cx, cfg.camera.cy = float(K[0, 2]), float(K[1, 2])
    cfg.extraction.num_features = 8024
    cfg.matching.match_type = "sequential"
    cfg.matching.overlap = 12
    cfg.bundle.dense_max_images = dense_max_images
    quiet = lambda *a: None  # noqa: E731
    cli.cmd_extract(cfg, device=device, log=quiet)
    cli.cmd_match(cfg, device=device, log=quiet)
    builder = cli.cmd_reconstruct(cfg, device=device, log=quiet)
    db = Database(cfg.database_path)
    try:
        ids = sorted(db.read_all_images())
        features = [(db.read_keypoints(i), db.read_descriptors(i)) for i in ids]
        matches = db.read_all_matches()
    finally:
        db.close()
    m = builder.map
    files = {}
    colmap = os.path.join(root, "colmap")
    for name in sorted(os.listdir(colmap)):
        if name.endswith(".txt"):
            with open(os.path.join(colmap, name), "rb") as f:
                files[f"colmap/{name}"] = f.read()
    with open(os.path.join(root, "cloud.ply"), "rb") as f:
        files["cloud.ply"] = f.read()
    poses = {m.images[i].name: np.concatenate([np.asarray(m.images[i].R).ravel(),
                                                np.asarray(m.images[i].t).ravel()])
             for i in m.registered_ids}
    st = m.statistics()
    return {"features": features, "matches": matches, "files": files,
            "poses": poses, "registered": st.num_registered_images,
            "points": st.num_points3D}


def pipeline_twice(imgs, K, device, root: str, dense_max_images: int = 8) -> dict:
    """`sfm-torch` extract, match, reconstruct and export twice on the
    same views (written once as PNGs under `root`), each into its own
    database and output directory.  Compared: the features and match
    rows of the database, `colmap/*.txt` and `cloud.ply` byte for byte,
    and the registered poses.  The chip smoke's pipeline settings
    (8024 features, sequential matching with overlap 12), with global BA
    dense up to `dense_max_images` images and PCG beyond, so both solvers
    run."""
    from monocularsfm_torch.utils.png import write_png

    images = os.path.join(root, "images")
    os.makedirs(images, exist_ok=True)
    for i, im in enumerate(imgs):
        write_png(os.path.join(images, f"frame{i:04d}.png"), im)
    (a, b), walls = _twice(lambda k: _run_pipeline(
        images, K, device, os.path.join(root, ("first", "second")[k]),
        dense_max_images), device)
    features = len(a["features"]) == len(b["features"]) and all(
        bits_equal(x, y) for fa, fb in zip(a["features"], b["features"])
        for x, y in zip(fa, fb))
    matches = a["matches"].keys() == b["matches"].keys() and all(
        bits_equal(a["matches"][p], b["matches"][p]) for p in a["matches"])
    files = {k: a["files"][k] == b["files"].get(k) for k in a["files"]}
    common = sorted(a["poses"].keys() & b["poses"].keys())
    pose_diff = max((max_abs_diff(a["poses"][n], b["poses"][n]) for n in common),
                    default=0.0)
    equal = (features and matches and all(files.values())
             and a["files"].keys() == b["files"].keys())
    return {"equal": equal, "features_equal": features, "matches_equal": matches,
            "files_equal": files, "pose_max_abs_diff": pose_diff,
            "registered": [a["registered"], b["registered"]],
            "points": [a["points"], b["points"]],
            "descriptors": sum(len(f[1]) for f in a["features"] if f[1] is not None),
            "database": os.path.join(root, "first.db"), "wall_s": walls}


def phase_repeat(dev, renders, db16, pcg_prob):
    """One input, two runs, the same bits (the helpers above): dense BA
    on phase_ba_dense's ring and PCG BA on phase_ba_pcg's
    (`pcg_prob`, on the card) at the same fixed work, train_visual_vocab
    with REPEAT_WORDS words on every descriptor of the 16-view feature
    database `db16`, and `sfm-torch` extract, match, reconstruct and export
    of the first REPEAT_VIEWS renders, each twice.  Prints one {"repeat":
    ...} line with each item's equality (the pipeline's registered images
    and points of both runs too), and fails if any pair differs.  Returns
    the kernels' launches in the two pipelines and the details."""
    from monocularsfm_torch.ops import blur, match_kernel
    from monocularsfm_torch.utils.ring_problem import ring_problem

    res = {}
    prob = ring_problem(BA_CAMS, BA_POINTS, BA_TRACK, seed=2)[0].to(dev)
    res["dense"] = ba_twice(prob, dev, max_iterations=BA_ITERS, **FIXED_WORK)
    del prob
    res["pcg"] = ba_twice(pcg_prob, dev, max_iterations=PCG_LM_ITERS,
                          solve_mode="pcg", pcg_iters=PCG_INNER, **FIXED_WORK)
    res["vocab"] = vocab_twice(descriptor_bank(db16), dev, REPEAT_WORDS)
    blur.reset_launches()
    match_kernel.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        res["pipeline"] = pipeline_twice(
            renders[0][:REPEAT_VIEWS], renders[1], dev, tmp, REPEAT_DENSE_MAX)
    launches = dict(blur.LAUNCHES, **match_kernel.LAUNCHES)
    del res["pipeline"]["database"]
    for name, r in res.items():
        log(f"[repeat] {name}: {json.dumps(r)}")
    summary = {name: {"equal": r["equal"]} for name, r in res.items()}
    summary["pipeline"].update(registered=res["pipeline"]["registered"],
                               points=res["pipeline"]["points"])
    print(json.dumps({"repeat": summary}), flush=True)
    if not all(r["equal"] for r in res.values()):
        fail(f"one input gave two results: {summary}")
    if not (launches["blur_vh"] > 0 and launches["match_tile"] > 0):
        fail(f"repeated pipelines' kernel launches {launches}")
    return launches, res


class HostDraws:
    """Stands in for an engine's `_draw(num_hyps, cap)`: uniforms from a CPU
    torch.Generator seeded as the engine's own, moved to `device`, so that
    a build on the card and one on the CPU get the same samples."""

    def __init__(self, seed: int, device):
        self.gen = torch.Generator().manual_seed(seed)
        self.device = device

    def __call__(self, num_hyps: int, cap: int) -> torch.Tensor:
        return torch.rand((num_hyps, cap), generator=self.gen).to(self.device)


def build_from_database(database_path: str, K, device, events: str,
                        dense_max_images: int) -> dict:
    """The MapBuilder on a database's features and matches, as
    `cmd_reconstruct` sets it up, with HostDraws for the initializer (42)
    and the registrant (7) and its event log written to `events`."""
    from monocularsfm_torch.config import SfMConfig
    from monocularsfm_torch.database import Database
    from monocularsfm_torch.reconstruction import MapBuilder

    cfg = SfMConfig(database_path=database_path)
    cfg.camera.fx, cfg.camera.fy = float(K[0, 0]), float(K[1, 1])
    cfg.camera.cx, cfg.camera.cy = float(K[0, 2]), float(K[1, 2])
    cfg.bundle.dense_max_images = dense_max_images
    db = Database(database_path)
    try:
        names = db.read_all_images()
        keypoints = {i: db.read_keypoints(i) for i in names}
        matches = {p: m for p, m in db.read_all_matches().items() if len(m)}
    finally:
        db.close()
    b = MapBuilder(cfg, device=device)
    b._log = lambda *a: None
    b.initializer._draw = HostDraws(42, b.device)
    b.registrant._draw = HostDraws(7, b.device)
    b.enable_metrics(events)
    t0 = time.perf_counter()
    try:
        b.setup(matches, keypoints, names=names)
        st = b.do_build()
    finally:
        b.close()
    wall = time.perf_counter() - t0
    with open(events) as f:
        ev = [json.loads(line) for line in f]
    m = b.map
    poses = {m.images[i].name: (np.asarray(m.images[i].R), np.asarray(m.images[i].t))
             for i in m.registered_ids}
    return {"summary": st, "poses": poses, "wall_s": wall,
            "events": [(e["event"], e.get("image_id"), e.get("solver")) for e in ev]}


def phase_width(dev, renders, db16):
    """The main path at its users' widths, card against CPU.  (a) SIFT with
    the default settings on the first 1280x960 render (more keypoints
    than the 8024 cap keeps) in both samplers: counts within KP_COUNT_TOL,
    KP_AGREE of the keypoints paired within KP_TOL both ways, paired
    descriptors within DESC_TOL, as in phase_sift.  (b) The MapBuilder
    from one database: the 16-view feature database `db16` matched once
    on the card (the smoke's pipeline settings), then built on the card
    and on the CPU with the same host-made draws (HostDraws): the same
    registered images, the same events and global-BA solvers, points and
    camera centres within the WIDTH_ tolerances.  Returns the kernels'
    launches (SIFT and matching on the card) and the figures."""
    import shutil

    from monocularsfm_torch import cli
    from monocularsfm_torch.config import SfMConfig
    from monocularsfm_torch.ops import blur, match_kernel
    from monocularsfm_torch.ops.sift import SIFT
    from monocularsfm_torch.utils.synthetic import similarity_align

    imgs, K = renders[0], renders[1]
    res = {}
    blur.reset_launches()
    match_kernel.reset_launches()
    for mode in ("patch", "gather"):
        t0 = time.perf_counter()
        kc, dc = SIFT(sample_mode=mode, device="cpu").extract(imgs[0])
        t1 = time.perf_counter()
        kg, dg = SIFT(sample_mode=mode, device=dev).extract(imgs[0])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        j = pair_keypoints(kc, kg)
        share = min((j >= 0).mean(), (pair_keypoints(kg, kc) >= 0).mean())
        derr = float(np.abs(dc[j >= 0] - dg[j[j >= 0]]).max())
        res[f"sift_{mode}"] = {"keypoints_cuda": len(kg), "keypoints_cpu": len(kc),
                               "paired_share": float(share),
                               "descriptor_err": derr, "cpu_s": t1 - t0,
                               "cuda_s": t2 - t1}
        log(f"[width] SIFT {mode} {MP_W}x{MP_H}: {len(kc)} cpu / {len(kg)} cuda "
            f"keypoints, {share:.4f} paired within {KP_TOL} px both ways, "
            f"descriptor err {derr:.3g} | cpu {t1 - t0:.1f}s, cuda {t2 - t1:.2f}s")
        if (abs(len(kg) - len(kc)) > KP_COUNT_TOL * len(kc) or share < KP_AGREE
                or derr > DESC_TOL):
            fail(f"{mode} SIFT cuda vs cpu at {MP_W}x{MP_H}: {len(kg)} vs {len(kc)} "
                 f"keypoints, paired {share} (need {KP_AGREE}), descriptor err "
                 f"{derr} (tol {DESC_TOL})")
    with tempfile.TemporaryDirectory() as tmp:
        db = os.path.join(tmp, "width.db")
        shutil.copy(db16, db)
        cfg = SfMConfig(database_path=db)
        cfg.matching.match_type = "sequential"
        cfg.matching.overlap = 12
        t0 = time.perf_counter()
        pairs = cli.cmd_match(cfg, device=dev, log=lambda *a: None)
        res["match_s"] = time.perf_counter() - t0
        launches = dict(blur.LAUNCHES, **match_kernel.LAUNCHES)
        card = build_from_database(db, K, dev, os.path.join(tmp, "card.jsonl"),
                                   WIDTH_DENSE_MAX)
        host = build_from_database(db, K, "cpu", os.path.join(tmp, "host.jsonl"),
                                   WIDTH_DENSE_MAX)
    sc, sh = card["summary"], host["summary"]
    common = sorted(card["poses"].keys() & host["poses"].keys())
    cc = np.array([-R.T @ t for R, t in (card["poses"][n] for n in common)])
    ch = np.array([-R.T @ t for R, t in (host["poses"][n] for n in common)])
    diag = float(np.linalg.norm(np.ptp(ch, axis=0)))
    centre_pct = 100.0 * similarity_align(cc, ch)[1] / diag
    rot = max(float(np.abs(card["poses"][n][0] - host["poses"][n][0]).max())
              for n in common)
    solvers = [e[2] for e in card["events"] if e[0] == "global_ba"]
    res["mapbuilder"] = {
        "views": WIDTH_VIEWS, "pairs": pairs,
        "registered": [sc.num_registered, sh.num_registered],
        "points": [sc.num_points3D, sh.num_points3D],
        "mean_reproj_px": [sc.mean_reprojection_error, sh.mean_reprojection_error],
        "centre_rms_pct_of_diagonal": centre_pct, "rotation_max_abs_diff": rot,
        "events_equal": card["events"] == host["events"],
        "global_ba_solvers": solvers, "wall_s": [card["wall_s"], host["wall_s"]]}
    log(f"[width] MapBuilder on {WIDTH_VIEWS} views, card vs cpu: "
        f"{json.dumps(res['mapbuilder'])}")
    log(f"[width] launches {launches}")
    if (set(card["poses"]) != set(host["poses"])
            or sc.num_registered < WIDTH_VIEWS - 1):
        fail(f"MapBuilder card vs cpu: registered {sorted(card['poses'])} against "
             f"{sorted(host['poses'])}")
    if card["events"] != host["events"] or "pcg" not in solvers:
        fail(f"MapBuilder card vs cpu: events {card['events']} against "
             f"{host['events']}")
    if abs(sc.num_points3D - sh.num_points3D) > WIDTH_POINTS_RTOL * sh.num_points3D:
        fail(f"MapBuilder card vs cpu: {sc.num_points3D} against {sh.num_points3D} "
             f"points (tol {WIDTH_POINTS_RTOL})")
    if not centre_pct < WIDTH_CENTRE_PCT:
        fail(f"MapBuilder card vs cpu: camera centres {centre_pct}% of the "
             f"diagonal apart (tol {WIDTH_CENTRE_PCT}%)")
    # blur_vh once for the base and once per octave of each SIFT on the
    # card, match_tile once per batch of pairs.
    expect = {"blur_vh": 2 * (1 + SIFT().num_octaves(MP_H, MP_W)),
              "match_tile": -(-pairs // cfg.matching.pair_batch)}
    if any(launches[k] != n for k, n in expect.items()):
        fail(f"width phase kernel launches {launches}, expected {expect}")
    return launches, res


def profiled_launches(fn):
    """(fn(), device kernel launches, their busy ms) under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return out, len(kernels), sum(e.time_range.elapsed_us() for e in kernels) / 1e3


def gather_vs_patch(kg, dg, kp, dp, H, W):
    """The reference's rule for its two samplers (tests/test_sift.py::
    test_patch_path_matches_gather_path): keypoints farther from the border
    than the descriptor's reach, paired by (x, y, angle) rounded to (0.01,
    0.01, 1); returns (paired share of the larger interior set, the paired
    descriptors' max abs difference)."""
    def interior(kp):
        margin = 4.0 * kp[:, 2] + 6.0
        return ((kp[:, 0] > margin) & (kp[:, 0] < W - margin)
                & (kp[:, 1] > margin) & (kp[:, 1] < H - margin))

    def keyed(k):
        return {(round(float(k[i, 0]), 2), round(float(k[i, 1]), 2),
                 round(float(k[i, 3]), 0)): i for i in np.nonzero(interior(k))[0]}

    a, b = keyed(kg), keyed(kp)
    common = sorted(set(a) & set(b))
    if not common:
        return 0.0, math.inf
    ia = np.asarray([a[c] for c in common])
    ib = np.asarray([b[c] for c in common])
    return (len(common) / max(len(a), len(b)),
            float(np.abs(dg[ia] - dp[ib]).max()))


def sift_modes(dev, imgs, reps=3):
    """Both samplers on one batch on the card: the median wall of
    extract_batch (after a warm-up), peak memory, launches and busy time of
    one profiled call, and the outputs."""
    from monocularsfm_torch.ops.sift import SIFT

    res = {}
    for mode in ("gather", "patch"):
        sift = SIFT(sample_mode=mode, device=dev)
        sift.extract_batch(imgs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = sift.extract_batch(imgs)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        _, launches, busy = profiled_launches(lambda: sift.extract_batch(imgs))
        res[mode] = {"out": out, "ms": 1e3 * float(np.median(walls)),
                     "peak_bytes": peak, "launches": launches, "busy_ms": busy}
    return res


def seg_pair(name, gpu, dev, step, **kw):
    """One segment against segments of `step` LM iterations, same work."""
    mono, t_mono = timed_ba(gpu, dev, **kw)
    seg, t_seg = timed_ba(gpu, dev, dispatch_iters=step, **kw)
    a, b = float(mono["rmse_final"]), float(seg["rmse_final"])
    rel = abs(a - b) / a
    log(f"[gather] {name}: {mono['iterations']} LM iters in one segment "
        f"{t_mono:.4f}s, in segments of {step} {t_seg:.4f}s "
        f"({seg['iterations']} iters); rmse {a:.6f} vs {b:.6f} (rel {rel:.2e})")
    if not (rel <= SEG_RTOL and max(a, b) <= RMSE_MAX
            and seg["iterations"] == mono["iterations"]):
        fail(f"{name}: segmented rmse_final {b} vs one segment {a} (rel {rel}, "
             f"tol {SEG_RTOL}), iterations {seg['iterations']} vs "
             f"{mono['iterations']}")
    return mono, {"iterations": mono["iterations"], "one_segment_s": t_mono,
                  "segmented_s": t_seg, "step": step, "rmse_final": a,
                  "segmented_rmse_final": b, "rmse_rel": rel}


def phase_gather(dev, renders):
    """SIFT's gather sampler (`sample_mode: gather`) and resumable LM on the
    card.  The slice's 4-image 1280x960 batch through both samplers (ms per
    batch, launches, idle, peak), gather on the card against gather on the
    CPU for one image, and gather against patch under the reference's
    rule; one 3200x2400 image the same way; `sfm-torch` extract, match and
    reconstruct with `sample_mode: gather` on the first GATHER_VIEWS of the
    main pipeline's renders (`renders`: images, K, R, t), counting the
    kernels it launches; then LM in segments (`dispatch_iters`) against one
    segment on the dense and PCG rings, and PCG on shuffled split rows."""
    import dataclasses

    from monocularsfm_torch import cli
    from monocularsfm_torch.config import SfMConfig
    from monocularsfm_torch.ops import blur, match_kernel
    from monocularsfm_torch.ops.sift import SIFT
    from monocularsfm_torch.utils.png import write_png
    from monocularsfm_torch.utils.ring_problem import ring_problem
    from monocularsfm_torch.utils.synthetic import render_textured_images

    res = {}
    t0 = time.perf_counter()
    imgs = render_textured_images(num_cameras=GATHER_IMAGES, width=SLICE_W,
                                  height=SLICE_H, scene_seed=5)[0]
    log(f"[gather] rendered {GATHER_IMAGES} images {SLICE_W}x{SLICE_H} in "
        f"{time.perf_counter() - t0:.1f}s")
    modes = sift_modes(dev, imgs)
    t0 = time.perf_counter()
    kc, dc = SIFT(sample_mode="gather", device="cpu").extract(imgs[0])
    t_cpu = time.perf_counter() - t0
    (kg, *_), (dg, *_) = modes["gather"]["out"]
    j = pair_keypoints(kc, kg)
    share = min((j >= 0).mean(), (pair_keypoints(kg, kc) >= 0).mean())
    derr = float(np.abs(dc[j >= 0] - dg[j[j >= 0]]).max())
    log(f"[gather] {SLICE_W}x{SLICE_H} image 0: {len(kc)} cpu / {len(kg)} cuda "
        f"keypoints, {share:.4f} paired within {KP_TOL} px both ways, "
        f"descriptor err {derr:.3g} (cpu {t_cpu:.1f}s)")
    if (abs(len(kg) - len(kc)) > KP_COUNT_TOL * len(kc) or share < KP_AGREE
            or derr > DESC_TOL):
        fail(f"gather SIFT cuda vs cpu: {len(kg)} vs {len(kc)} keypoints, paired "
             f"{share} (need {KP_AGREE}), descriptor err {derr} (tol {DESC_TOL})")
    rule = [gather_vs_patch(kg_, dg_, kp_, dp_, SLICE_H, SLICE_W)
            for kg_, dg_, kp_, dp_ in zip(*modes["gather"]["out"],
                                         *modes["patch"]["out"])]
    for mode, m in modes.items():
        log(f"[gather] {mode}: {m['ms']:.2f} ms per {GATHER_IMAGES}-image batch, "
            f"{m['launches']} launches, busy {m['busy_ms']:.2f} ms (profiled), "
            f"peak {m['peak_bytes'] / 2**30:.2f} GiB, keypoints "
            f"{[len(k) for k in m['out'][0]]}")
    log(f"[gather] gather vs patch (shared interior share, descriptor err) "
        f"per image: {rule}")
    if min(r[0] for r in rule) < GATHER_SHARED or max(r[1] for r in rule) >= GATHER_DESC_TOL:
        fail(f"gather vs patch at {SLICE_W}x{SLICE_H}: {rule} (need shared >= "
             f"{GATHER_SHARED}, descriptors < {GATHER_DESC_TOL})")
    res["batch_1280x960"] = {
        mode: {k: v for k, v in m.items() if k != "out"} | {
            "keypoints": [len(k) for k in m["out"][0]]}
        for mode, m in modes.items()}
    res["batch_1280x960"]["cuda_vs_cpu"] = {
        "keypoints": [len(kg), len(kc)], "paired_share": float(share),
        "descriptor_err": derr, "cpu_s": t_cpu}
    res["batch_1280x960"]["gather_vs_patch"] = rule
    del modes

    t0 = time.perf_counter()
    big = render_textured_images(num_cameras=1, width=BIG_W, height=BIG_H,
                                 scene_seed=BIG_SEED)[0]
    log(f"[gather] rendered {BIG_W}x{BIG_H} in {time.perf_counter() - t0:.1f}s")
    modes = sift_modes(dev, big, reps=2)
    (kg, dg), (kp, dp) = ((m["out"][0][0], m["out"][1][0]) for m in modes.values())
    big_rule = gather_vs_patch(kg, dg, kp, dp, BIG_H, BIG_W)
    for mode, m in modes.items():
        log(f"[gather] {BIG_W}x{BIG_H} {mode}: {m['ms'] / 1e3:.4f} s/image, "
            f"{m['launches']} launches, busy {m['busy_ms']:.2f} ms, peak "
            f"{m['peak_bytes'] / 2**30:.2f} GiB, {len(m['out'][0][0])} keypoints")
    log(f"[gather] {BIG_W}x{BIG_H} gather vs patch: {big_rule}")
    if big_rule[0] < GATHER_SHARED or big_rule[1] >= GATHER_DESC_TOL:
        fail(f"gather vs patch at {BIG_W}x{BIG_H}: {big_rule}")
    res["image_3200x2400"] = {
        mode: {k: v for k, v in m.items() if k != "out"} | {
            "keypoints": len(m["out"][0][0])}
        for mode, m in modes.items()}
    res["image_3200x2400"]["gather_vs_patch"] = big_rule
    del modes, big

    imgs, K = renders[0][:GATHER_VIEWS], renders[1]
    quiet = lambda *a: None  # noqa: E731
    stages = {}
    with tempfile.TemporaryDirectory() as tmp:
        images = os.path.join(tmp, "images")
        os.makedirs(images)
        for i, im in enumerate(imgs):
            write_png(f"{images}/frame{i:04d}.png", im)
        cfg = SfMConfig(images_path=images, database_path=f"{tmp}/gather.db",
                        output_path=f"{tmp}/out")
        cfg.camera.fx, cfg.camera.fy = float(K[0, 0]), float(K[1, 1])
        cfg.camera.cx, cfg.camera.cy = float(K[0, 2]), float(K[1, 2])
        cfg.extraction.num_features = 8024
        cfg.extraction.sample_mode = "gather"
        cfg.matching.match_type = "sequential"
        cfg.matching.overlap = 12
        blur.reset_launches()
        match_kernel.reset_launches()
        for name, fn in (("extract", cli.cmd_extract), ("match", cli.cmd_match),
                         ("reconstruct", cli.cmd_reconstruct)):
            torch.cuda.synchronize()
            a0 = time.perf_counter()
            builder = fn(cfg, device=dev, log=quiet)
            torch.cuda.synchronize()
            stages[name] = time.perf_counter() - a0
        launches = dict(blur.LAUNCHES, **match_kernel.LAUNCHES)
        st = builder.map.statistics()
    log(f"[gather] pipeline on {GATHER_VIEWS} views with sample_mode gather: "
        f"{st.num_registered_images} registered, {st.num_points3D} points, mean "
        f"reproj {st.mean_reprojection_error:.5f} px; stages (s) {stages}; "
        f"launches {launches}")
    if (st.num_registered_images < GATHER_MIN_REG
            or not st.mean_reprojection_error < MP_REPROJ_MAX):
        fail(f"gather pipeline: {st.num_registered_images} of {GATHER_VIEWS} "
             f"registered, {st.mean_reprojection_error} px")
    if not (launches["blur_vh"] > 0 and launches["match_tile"] > 0):
        fail(f"gather pipeline kernel launches {launches}")
    res["pipeline"] = {"views": GATHER_VIEWS,
                       "registered": st.num_registered_images,
                       "points": st.num_points3D,
                       "mean_reproj_px": st.mean_reprojection_error,
                       "stage_s": stages}

    dense, _ = ring_problem(BA_CAMS, BA_POINTS, BA_TRACK, seed=2)
    _, res["segmented_dense"] = seg_pair(
        "dense", dense.to(dev), dev, SEG_DENSE_STEP,
        max_iterations=SEG_DENSE_ITERS, **FIXED_WORK)
    del dense
    pcg, _ = ring_problem(PCG_CAMS, PCG_POINTS, PCG_TRACK, seed=3, row_width=3)
    gpu = pcg.to(dev)
    del pcg
    kw = dict(max_iterations=PCG_LM_ITERS, solve_mode="pcg", pcg_iters=PCG_INNER,
              **FIXED_WORK)
    mono, res["segmented_pcg"] = seg_pair("pcg", gpu, dev, SEG_PCG_STEP, **kw)
    perm = torch.from_numpy(np.random.default_rng(SEED).permutation(
        gpu.obs_cam.shape[0])).to(dev)
    shuffled = dataclasses.replace(gpu, **{
        f: getattr(gpu, f)[perm] for f in ("obs_cam", "obs_uv", "obs_valid",
                                           "point_rows")})
    del gpu
    out, t_shuf = timed_ba(shuffled, dev, **kw)
    a, b = float(mono["rmse_final"]), float(out["rmse_final"])
    rel = abs(a - b) / a
    log(f"[gather] pcg on shuffled split rows: {out['iterations']} LM iters in "
        f"{t_shuf:.4f}s, rmse {b:.6f} vs sorted {a:.6f} (rel {rel:.2e})")
    if rel > SEG_RTOL:
        fail(f"PCG on shuffled rows: rmse_final {b} vs sorted {a} (rel {rel})")
    res["pcg_shuffled_rows"] = {"s": t_shuf, "rmse_final": b, "rmse_rel": rel}
    return launches, res


def pair_keypoints(ka, kb):
    """For each keypoint of `ka`, the index of a keypoint of `kb` within
    KP_TOL on both axes and 0.5 degrees of orientation, or -1 (a k-d tree,
    for the 8024 keypoints of a 3200x2400 image)."""
    from scipy.spatial import cKDTree

    dist, idx = cKDTree(kb[:, :2]).query(ka[:, :2], k=8, p=np.inf,
                                         distance_upper_bound=KP_TOL)
    out = np.full(len(ka), -1)
    for r in range(len(ka)):
        for d, j in zip(dist[r], idx[r]):
            if d < KP_TOL and abs((ka[r, 3] - kb[j, 3] + 180.0) % 360.0 - 180.0) <= 0.5:
                out[r] = j
                break
    return out


def phase_3200(dev):
    """The shipped configs' image size: the fused blur at its octave-0 shape;
    one 3200x2400 image through SIFT on the card against the port's CPU path
    (counts within KP_COUNT_TOL, KP_AGREE of the keypoints within KP_TOL
    both ways); then `sfm-torch extract` of two 4000x3000 PNGs, which the
    stage's integer resize brings to 3200x2400 (keypoints those of the
    resized image scaled back, 128-wide descriptors in the database)."""
    from monocularsfm_torch import cli
    from monocularsfm_torch.config import SfMConfig
    from monocularsfm_torch.database import Database
    from monocularsfm_torch.features.extraction import _resize, _scale_for
    from monocularsfm_torch.ops import blur, match_kernel
    from monocularsfm_torch.ops.sift import SIFT
    from monocularsfm_torch.utils.png import write_png
    from monocularsfm_torch.utils.synthetic import render_textured_images

    blur_rows = check_blur(dev, BIG_SHAPE)
    t0 = time.perf_counter()
    img = render_textured_images(num_cameras=1, width=BIG_W, height=BIG_H,
                                 scene_seed=BIG_SEED)[0][0]
    t_render = time.perf_counter() - t0
    sift = SIFT(device=dev)
    sift.extract(img)                                       # first-call costs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    kg, dg = sift.extract(img)
    torch.cuda.synchronize()
    t_cuda = time.perf_counter() - t0
    peak_sift = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    kc, dc = SIFT(device="cpu").extract(img)
    t_cpu = time.perf_counter() - t0
    j = pair_keypoints(kc, kg)
    paired = j >= 0
    share = min(paired.mean(), (pair_keypoints(kg, kc) >= 0).mean())
    derr = np.abs(dc[paired] - dg[j[paired]]).max()
    log(f"[3200] SIFT {BIG_W}x{BIG_H} (rendered in {t_render:.1f}s): {len(kc)} cpu / "
        f"{len(kg)} cuda keypoints, {share:.4f} paired within {KP_TOL} px both "
        f"ways, descriptor err {derr:.3g} | cuda {t_cuda:.3f}s (peak "
        f"{peak_sift / 2**30:.2f} GiB), cpu {t_cpu:.1f}s")
    if (abs(len(kg) - len(kc)) > KP_COUNT_TOL * len(kc) or share < KP_AGREE
            or derr > DESC_TOL):
        fail(f"SIFT {BIG_W}x{BIG_H} cuda vs cpu: {len(kg)} vs {len(kc)} keypoints "
             f"(tol {KP_COUNT_TOL}), paired {share} (need {KP_AGREE}), descriptor "
             f"err {derr} (tol {DESC_TOL})")

    t0 = time.perf_counter()
    huge = render_textured_images(num_cameras=HUGE_IMAGES, width=HUGE_W,
                                  height=HUGE_H, scene_seed=BIG_SEED)[0]
    with tempfile.TemporaryDirectory() as tmp:
        images = os.path.join(tmp, "images")
        os.makedirs(images)
        for i, im in enumerate(huge):
            write_png(f"{images}/big{i}.png", im)
        t_prep = time.perf_counter() - t0
        cfg = SfMConfig(images_path=images, database_path=f"{tmp}/big.db")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        blur.reset_launches()
        match_kernel.reset_launches()
        t0 = time.perf_counter()
        n_img = cli.cmd_extract(cfg, device=dev, log=lambda *a: None)
        torch.cuda.synchronize()
        t_extract = time.perf_counter() - t0
        launches = dict(blur.LAUNCHES, **match_kernel.LAUNCHES)
        peak_extract = torch.cuda.max_memory_allocated()
        db = Database(cfg.database_path)
        try:
            ids = sorted(db.read_all_images())
            kps = [db.read_keypoints(i) for i in ids]
            descs = [db.read_descriptors(i) for i in ids]
        finally:
            db.close()
    octaves = sift.num_octaves(BIG_H, BIG_W)
    per_image = 1 + octaves
    # The stage's keypoints are SIFT's on the resized image, scaled back.
    scale = _scale_for(cfg.extraction.max_image_size, HUGE_H, HUGE_W)
    k_ref = sift.extract(_resize(huge[0], BIG_H, BIG_W))[0]
    k_err = (np.abs(kps[0][:, :3] - k_ref[:, :3] / scale).max()
             if len(k_ref) == len(kps[0]) else math.inf)
    log(f"[3200] extract {n_img} PNGs {HUGE_W}x{HUGE_H} (rendered and written in "
        f"{t_prep:.1f}s) in {t_extract:.2f}s: keypoints {[len(k) for k in kps]}, "
        f"against SIFT of the resized image / {scale}: {len(k_ref)} keypoints, "
        f"max diff {k_err:.3g} px; peak {peak_extract / 2**30:.2f} GiB, launches "
        f"{launches} (expected blur_vh {HUGE_IMAGES} x (1 + {octaves}))")
    if n_img != HUGE_IMAGES or len(ids) != HUGE_IMAGES:
        fail(f"extracted {n_img} of {HUGE_IMAGES} 4000x3000 images")
    if not k_err <= 1e-3:
        fail(f"4000x3000 extraction: keypoints differ from SIFT of the resized "
             f"image scaled back by {k_err} px")
    for k, d in zip(kps, descs):
        inside = ((k[:, 0] >= 0) & (k[:, 0] < HUGE_W) & (k[:, 1] >= 0)
                  & (k[:, 1] < HUGE_H)).all()
        if not (len(k) >= MIN_KEYPOINTS and inside
                and d.shape == (len(k), 128) and np.isfinite(d).all()):
            fail(f"4000x3000 extraction: {len(k)} keypoints, inside {inside}, "
                 f"descriptors {d.shape}")
    if launches["blur_vh"] != HUGE_IMAGES * per_image:
        fail(f"4000x3000 extraction launched blur_vh {launches['blur_vh']} times, "
             f"expected {HUGE_IMAGES * per_image}")
    return blur_rows, launches, {
        "sift_3200_keypoints": len(kg), "sift_3200_cpu_keypoints": len(kc),
        "sift_3200_paired_share": float(share),
        "sift_3200_descriptor_err": float(derr), "sift_3200_cuda_s": t_cuda,
        "sift_3200_cpu_s": t_cpu, "sift_3200_peak_bytes": peak_sift,
        "extract_4000x3000_images": n_img, "extract_4000x3000_s": t_extract,
        "extract_4000x3000_keypoints": [len(k) for k in kps],
        "extract_4000x3000_peak_bytes": peak_extract,
    }


def parallel_ba_single(dev):
    """(a) A world of one NCCL rank in this process: distributed_bundle_adjust
    against bundle_adjust on the dense headline ring and the scaling
    table's PCG ring, the same fixed work each.  Returns per problem the
    unsharded and the sharded rmse_final and LM iterations/s."""
    import torch.distributed as dist

    from monocularsfm_torch.optim import bundle_adjust
    from monocularsfm_torch.parallel import distributed_bundle_adjust
    from monocularsfm_torch.parallel import mesh as PM
    from monocularsfm_torch.utils.ring_problem import ring_problem

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        PM.init_multi_host(f"file://{tmp}/store", 1, 0, device=dev,
                           timeout_s=PAR_TIMEOUT)
        try:
            backend = dist.get_backend()
            mesh = PM.make_mesh(1, device=dev)
            for name, (cams, points, track, seed), kw in PAR_PROBLEMS:
                prob = ring_problem(cams, points, track, seed=seed)[0].to(dev)
                bundle_adjust(prob, device=dev, **dict(kw, max_iterations=2))
                single, dt1 = timed_ba(prob, dev, **kw)
                distributed_bundle_adjust(prob, mesh, **dict(kw, max_iterations=2))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sharded = distributed_bundle_adjust(prob, mesh, **kw)
                torch.cuda.synchronize()
                dt2 = time.perf_counter() - t0
                out[name] = {
                    "unsharded_rmse_final": float(single["rmse_final"]),
                    "unsharded_lm_iters_per_s": single["iterations"] / dt1,
                    "world1_rmse_final": float(sharded["rmse_final"]),
                    "world1_lm_iters_per_s": sharded["iterations"] / dt2,
                    "lm_iters": sharded["iterations"]}
                del prob
        finally:
            PM.shutdown()
    return backend, out


def phase_parallel(dev, db16, K):
    """The multi-device layer on the one card: (a) distributed BA as a world
    of one NCCL rank in this process, and (b) as two gloo ranks sharing the
    card, each within PAR_RMSE_TOL of the unsharded solve on the dense and
    the PCG ring, with the ranks' time inside collectives; (c) pair-sharded
    matching over the two ranks equal to the single-device kernel's maps,
    and (d) the ring all-pairs matching equal to the direct per-pair
    matches, match_tile launched on each rank; (e) the dry run, then
    `sfm-torch match` + `reconstruct` under two ranks on PAR_VIEWS views."""
    from monocularsfm_torch.ops.matching import match_pairs_batch, matches_to_pairs
    from monocularsfm_torch.parallel.dryrun import dryrun_multichip
    from monocularsfm_torch.parallel.mesh import spawn

    res = {}
    backend1, res["world1"] = parallel_ba_single(dev)
    log(f"[parallel] (a) world of one, backend {backend1}: {res['world1']}")
    if backend1 != "nccl":
        fail(f"a world of one on the card chose {backend1}, not nccl")

    bank, mask, _ = match_bank(dev)
    bank, mask = bank[:PAR_MATCH_IMAGES], mask[:PAR_MATCH_IMAGES]
    n = PAR_MATCH_IMAGES
    pairs = np.array([[i, j] for i in range(n) for j in range(i + 1, n)], np.int32)
    ref = match_pairs_batch(bank, mask, pairs).cpu().numpy()
    host_bank = bank.float().cpu().numpy()
    host_mask = mask.cpu().numpy()
    step = "monocularsfm_torch.parallel.dryrun:"
    t0 = time.perf_counter()
    ranks = spawn(2, [(step + "ring_ba", (*shape, dev), kw)
                      for _, shape, kw in PAR_PROBLEMS] + [
        (step + "match", (host_bank, host_mask, pairs, dev), {}),
        (step + "ring", (host_bank, host_mask, dev),
         dict(cross_check=True, max_matches=MATCH_CAP)),
    ], device=dev, timeout=PAR_TIMEOUT)
    res["gloo2_wall_s"] = time.perf_counter() - t0
    for k, (name, _, _) in enumerate(PAR_PROBLEMS):
        r = ranks[0][k]
        res[name] = {
            "gloo2_rmse_final": r["rmse_final"], "gloo2_backend": r["backend"],
            "gloo2_lm_iters_per_s": r["iterations"] / r["wall_s"],
            "gloo2_wall_s": r["wall_s"], "gloo2_lm_iters": r["iterations"],
            "gloo2_collective_s": [rk[k]["collective_s"] for rk in ranks],
            "gloo2_collective_calls": r["collective_calls"],
            "gloo2_collective_bytes": r["collective_bytes"],
            **res["world1"][name]}
        r = res[name]
        r["gloo2_collective_share"] = max(r["gloo2_collective_s"]) / r["gloo2_wall_s"]
        log(f"[parallel] (a, b) {name}: {r}")
        for key in ("world1_rmse_final", "gloo2_rmse_final"):
            if not abs(r[key] - r["unsharded_rmse_final"]) <= PAR_RMSE_TOL:
                fail(f"sharded BA {name}: {key} {r[key]} against unsharded "
                     f"{r['unsharded_rmse_final']} (tol {PAR_RMSE_TOL} px)")
        if r["gloo2_backend"] != "gloo":
            fail(f"two ranks on one card chose {r['gloo2_backend']}")
    n_ba = len(PAR_PROBLEMS)
    launches = {"sharded_match_pairs": [rk[n_ba]["launches"] for rk in ranks],
                "ring_all_pairs_matching": [rk[n_ba + 1]["launches"] for rk in ranks]}
    same = all(np.array_equal(rk[n_ba]["idx"], ref) for rk in ranks)
    direct = {(int(a), int(b)): np.stack(matches_to_pairs(ref[p]), 1)
              for p, (a, b) in enumerate(pairs)}
    ring = ranks[0][n_ba + 1]["pairs"]
    ring_same = (ring.keys() == {k for k, v in direct.items() if len(v)}
                 and all(np.array_equal(ring[k], direct[k]) for k in ring))
    log(f"[parallel] (c) sharded_match_pairs over 2 ranks, {len(pairs)} pairs at "
        f"capacity {MATCH_CAP}: equal to the single-device kernel {same}; "
        f"(d) ring, cross-check: {len(ring)} pairs equal to the direct "
        f"matches {ring_same}; match_tile launches per rank {launches}")
    if not (same and ring_same):
        fail(f"sharded matching differs from the kernel: pairs {same}, ring {ring_same}")
    if not all(c > 0 for v in launches.values() for c in v):
        fail(f"match_tile was not launched on every rank: {launches}")
    res["match_launches"] = launches

    t0 = time.perf_counter()
    dry = dryrun_multichip(2, device=dev, timeout=PAR_TIMEOUT)
    res["dryrun_s"] = time.perf_counter() - t0
    res["dryrun_registered"] = dry["num_registered"]
    log(f"[parallel] (e) dryrun_multichip(2) in {res['dryrun_s']:.1f}s: "
        f"{dry['num_registered']} registered, global BAs (cams, solver, "
        f"sharded) {[(e['cams'], e['solver'], e['sharded']) for e in dry['events'] if e['event'] == 'global_ba']}")
    res["cli"] = parallel_cli(db16, K)
    return res


def parallel_cli(db16, K):
    """`sfm-torch match` and `reconstruct` under torch.distributed.run with
    two ranks on the card, on a copy of the 16-view feature database."""
    import shutil
    import subprocess

    from monocularsfm_torch.database import Database

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        db = os.path.join(tmp, "par.db")
        shutil.copy(db16, db)
        cfg = os.path.join(tmp, "par.yaml")
        with open(cfg, "w") as f:
            f.write(f"database_path: {db}\noutput_path: {tmp}/out\n"
                    f"images_path: {tmp}/images\n"
                    f"camera: {{fx: {float(K[0, 0])}, fy: {float(K[1, 1])}, "
                    f"cx: {float(K[0, 2])}, cy: {float(K[1, 2])}}}\n"
                    "matching: {match_type: sequential, overlap: 12}\n"
                    f"bundle: {{dense_max_images: {PAR_DENSE_MAX}}}\n")
        metrics = os.path.join(tmp, "events.jsonl")
        walls = {}
        for stage, extra in (("match", []), ("reconstruct", ["--metrics", metrics])):
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node", "2", "-m", "monocularsfm_torch.cli", stage,
                 cfg, *extra], cwd=root, capture_output=True, text=True,
                timeout=PAR_TIMEOUT)
            walls[stage] = time.perf_counter() - t0
            log(f"[parallel] sfm-torch {stage} under 2 ranks: rc {r.returncode} "
                f"in {walls[stage]:.1f}s")
            if r.returncode != 0:
                errors = [line for line in r.stderr.splitlines()
                          if "Error" in line or "error" in line]
                fail(f"sfm-torch {stage} under 2 ranks: {r.stdout[-2000:]}"
                     + "\n".join(errors[-40:]) + r.stderr[-3000:])
        backends = sorted({line.split("backend ")[1].split()[0]
                           for line in r.stderr.splitlines() if "backend " in line})
        with open(metrics) as f:
            gba = [e for e in map(json.loads, f) if e["event"] == "global_ba"]
        summary = [line for line in r.stdout.splitlines()
                   if "registered images" in line or "mean reprojection" in line]
        reg = int(summary[0].split(":")[1])
        reproj = float(summary[1].split(":")[1].split()[0])
        d = Database(db)
        try:
            pairs = sum(1 for m in d.read_all_matches().values() if len(m))
        finally:
            d.close()
    sharded = [(e["cams"], e["solver"]) for e in gba if e["sharded"]]
    log(f"[parallel] sfm-torch match + reconstruct, 2 ranks ({backends}): {pairs} "
        f"verified pairs, {reg}/{PAR_VIEWS} registered, mean reproj {reproj:.5f} "
        f"px, sharded global BAs (cams, solver) {sharded}")
    if backends != ["gloo"]:
        fail(f"sfm-torch under 2 ranks on one card chose {backends}")
    if not (reg >= PAR_MIN_REG and reproj < MP_REPROJ_MAX and sharded
            and any(sv == "pcg" for _, sv in sharded)):
        fail(f"sfm-torch under 2 ranks: {reg} registered, {reproj} px, "
             f"global BAs {gba}")
    return {"views": PAR_VIEWS, "registered": reg, "mean_reproj_px": reproj,
            "verified_pairs": pairs, "sharded_global_ba": sharded,
            "stage_s": walls}


def main():
    dev = "cuda"
    smi = phase_device()
    import monocularsfm_torch  # noqa: F401  (precision pins)

    phase_build()
    blur_rows = check_blur(dev)
    sim_err, agree, tm = check_matcher(dev)
    schur_entry = check_schur(dev)
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
    pcg_rates, pcg_prob = walled("ba_pcg", phase_ba_pcg, dev,
                                 rates["ba_dense_rmse_final"])
    rates.update(pcg_rates)
    launches_bench, single_pair, rectangular, rates["bench"] = walled(
        "bench", phase_bench, dev)
    par_tmp = tempfile.TemporaryDirectory()
    db16 = os.path.join(par_tmp.name, "features16.db")
    renders, launches, quality = walled("pipeline", phase_reconstruct, dev,
                                        MP_VIEWS, db16)
    rates.update(quality)
    launches_alt, rates["pipeline_alt"] = walled("pipeline_alt", phase_pipeline_alt,
                                                 dev, renders)
    launches_gather, rates["gather"] = walled("gather", phase_gather, dev, renders)
    launches_repeat, rates["repeat"] = walled("repeat", phase_repeat, dev, renders,
                                              db16, pcg_prob)
    launches_width, rates["width"] = walled("width", phase_width, dev, renders, db16)
    del pcg_prob
    K_mp = renders[1]
    del renders
    rates["pnp"] = walled("pnp", phase_pnp, dev)
    blur_3200, launches_3200, rates["size_3200"] = walled("size_3200", phase_3200, dev)
    rates["parallel"] = walled("parallel", phase_parallel, dev, db16, K_mp)
    par_tmp.cleanup()
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
                "launches_extract_4000x3000": launches_3200[name],
                "launches_bench": launches_bench[name],
                "launches_gather": launches_gather[name],
                "launches_repeat": launches_repeat[name],
                "launches_width": launches_width[name],
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
                   library_max_abs_err=err["vh_library"],
                   shape_3200={"shape": list(BIG_SHAPE), **{
                       name: {"max_abs_err": e["vh"], "equal_to_pair": eq,
                              "ms": bt["vh"], "plain_ms": bt["vh_plain"],
                              "bound_ms": bt["vh_bound"],
                              "bound_by": bt["vh_bound_by"],
                              "library_ms": bt["vh_library"]}
                       for name, e, eq, bt in blur_3200}}),
        entry("match_tile", "match_tile.cu", "pallas_matching.py:39", sim_err,
              tm["kernel"], tm["plain"], tm["bound"], tm["bound_by"],
              tm["library"], index_agreement=agree,
              match_stats_whole_ms=tm["whole"],
              library_is="bf16 torch.bmm of the product alone, not the same function",
              launches_parallel=rates["parallel"]["match_launches"],
              single_pair=single_pair, rectangular=rectangular,
              shape={"pairs": MATCH_IMAGES, "capacity": MATCH_CAP}),
        schur_entry,
    ]
    print(smi)
    print(json.dumps({"kernels": kernels, "extract_images_per_s": ips,
                      "match_pairs_per_s": pps, **rates}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
