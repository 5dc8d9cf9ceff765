"""The port's main path against the JAX package at its users' widths, on
the CPU: SIFT at 1280x960 with the default settings (8024 features,
4096 candidates per octave, many 512-candidate slabs per octave), in both
samplers and on an input whose keypoints the 8024 cap cuts; matching at
capacity 8192, square and (8192, 4096); F-RANSAC at full match counts;
the MapBuilder past the dense-to-PCG switch (56 cameras); and a 16-view
1280x960 pipeline from PNGs.

Each stage is fed the same input on both sides, so that a difference is
located in one stage: where a stage needs the previous one's output, both
packages read the JAX package's.  Random draws are inputs: the port's
engines and matcher get the JAX package's uniforms through their `_draw`
hooks.

Run the cases marked slow with
    python -m pytest tests/test_torch_full_width.py -m slow -p no:randomly
"""

import json

import numpy as np
import pytest
import torch

from monocularsfm_torch.utils.synthetic import (
    camera_ring_scene,
    render_multiplane_images,
    render_textured_images,
    similarity_align,
)
from test_map_builder import scene_to_matches
from test_torch_reconstruction import JaxDraws, patch_engine_draws
from test_torch_vocab import JaxMatchDraws

WIDTH, HEIGHT = 1280, 960
CAPACITY = 8192           # _pad_pow2 of an 8024-feature image
# The smoke's pipeline renders (chip_smoke.py: MP_SEED, MP_ARC_PER_VIEW).
MP_SEED, MP_ARC_PER_VIEW = 7, 200.0 / 128

# The 320x240 tolerances of tests/test_torch_sift.py.
KP_TOL, TOY_SIZE_ANGLE, TOY_DESC = 0.01, 0.05, 2e-3


def _pair(ka, kb, tol=KP_TOL):
    """For each keypoint of ka, the keypoint of kb at the same position
    (within tol px on each axis) and orientation (within 0.5 degrees), the
    nearest such (or -1)."""
    from scipy.spatial import cKDTree

    dxy, j = cKDTree(kb[:, :2]).query(ka[:, :2], k=8, p=np.inf,
                                      distance_upper_bound=tol)
    found = j < len(kb)
    jj = np.where(found, j, 0)
    dang = np.abs((ka[:, None, 3] - kb[jj, 3] + 180.0) % 360.0 - 180.0)
    cost = np.where(found & (dang <= 0.5), dxy, np.inf)
    best = cost.argmin(1)
    rows = np.arange(len(ka))
    return np.where(np.isfinite(cost[rows, best]), jj[rows, best], -1)


def _differences(ref, ours):
    """Over every view: the paired share per view, and per paired keypoint
    the larger of its size and angle differences and its largest descriptor
    difference."""
    paired, size_angle, desc = [], [], []
    for ka, da, kb, db in zip(*ref, *ours):
        j = _pair(ka, kb)
        ok = j >= 0
        paired.append(ok.mean())
        size_angle.append(np.abs(ka[ok, 2:] - kb[j[ok], 2:]).max(1))
        desc.append(np.abs(da[ok] - db[j[ok]]).max(1))
    return np.array(paired), np.concatenate(size_angle), np.concatenate(desc)


# ---------------------------------------------------------------------------
# 1. SIFT at 1280x960, the default settings


@pytest.fixture(scope="module")
def textured():
    return render_textured_images(num_cameras=2, width=WIDTH, height=HEIGHT,
                                  arc_deg=30.0, scene_seed=5)[0]


def _extract_both(imgs, sample_mode="patch", **kw):
    from monocularsfm_torch.ops import sift as T
    from monocularsfm_tpu.ops import sift as J

    ref = J.SIFT(sample_mode=sample_mode, **kw).extract_batch(imgs)
    ours = T.SIFT(sample_mode=sample_mode, device="cpu", **kw).extract_batch(imgs)
    return ref, ours


@pytest.fixture(scope="module")
def patch(textured):
    return _extract_both(textured)


def _holds_the_full_width_rule(ref, ours):
    """Counts within 1%, 99.5% of the keypoints paired, at most 0.1% of the
    paired keypoints over each 320x240 tolerance, and the 99.9th percentiles
    well inside them (see test_sift_patch_at_full_width)."""
    for ka, kb in zip(ref[0], ours[0]):
        assert len(ka) > 4000
        assert abs(len(ka) - len(kb)) <= 0.01 * len(ka)
    paired, size_angle, desc = _differences(ref, ours)
    assert paired.min() >= 0.995, paired
    assert (size_angle > TOY_SIZE_ANGLE).mean() <= 1e-3
    assert (desc > TOY_DESC).mean() <= 1e-3
    assert np.percentile(size_angle, 99.9) < 0.02
    assert np.percentile(desc, 99.9) < 5e-4
    return paired, size_angle, desc


def test_sift_patch_at_full_width(patch):
    """Two 1280x960 views (render_textured_images, scene_seed=5), patch
    sampler, default SIFT().  Measured on the CPU: 5065/5065 and 5078/5078
    keypoints, paired 100% and 99.96%; over the 10,141 paired keypoints the
    size/angle difference has its 99.9th percentile at 0.010 and its
    maximum at 0.083 (one keypoint over 0.05), the descriptor difference
    its 99.9th percentile at 2.4e-4 and its maximum at 2.49e-3 (one
    keypoint over 2e-3).

    Those two keypoints are f32 noise, not a fault:
    - the port's pyramid is the JAX package's Pallas blur, sum for sum
      (99.985% of the values bit-equal, at most one ulp apart); the JAX
      package's CPU path builds it with an XLA convolution instead, which
      differs from both by up to 2.4e-7 in 57% of the values;
    - on the JAX package's own pyramid the port's detection, orientation
      and descriptors agree to 1e-3 degrees and 1e-5 (at 2560x1920 and
      1280x960; test_sift_stages_agree_on_the_reference_pyramid);
    - the pyramid's rounding moves a few ill-conditioned refinements by
      1e-3 px, which moves the orientation histogram's parabolic peak by
      up to 0.083 degrees (view 1, keypoint 845); that turns the descriptor
      grid by as much, and a bin that is exactly 0 on one side receives
      6e-6 of the L1 mass on the other, which RootSIFT's square root
      magnifies to 2.49e-3 (view 0, keypoint 541, bin 59);
    - the JAX package against itself, compiled as one program and octave
      by octave, differs the same way: 0.029 degrees and 3.7e-4.
    So the rule bounds the share over the 320x240 tolerances, not the
    maximum."""
    _holds_the_full_width_rule(*patch)


def test_sift_stages_agree_on_the_reference_pyramid(textured):
    """One octave at 1280x960, view 0 as its base: the JAX package's
    Gaussian stack (its CPU convolution) fed to both packages' detection
    and patch sampler.  Measured: the port's stack from the same base
    3.6e-7 from it; the same 3,120 candidates valid, positions 6.1e-5
    octave px apart, angles 1.1e-3 degrees, the unnormalised descriptors
    1.2e-5.  Held to 1e-6, 2e-4, 5e-3 and 5e-5: the f32 rounding of one
    stage, 10x to 40x inside what the whole extraction shows."""
    import jax.numpy as jnp

    from monocularsfm_torch.ops import sift as T
    from monocularsfm_tpu.ops import sift as J

    base = textured[:1].astype(np.float32) / 255.0
    ref_stack = np.asarray(J._build_octave_batched_conv(jnp.asarray(base)))
    ours_stack = T._build_octave_batched(torch.from_numpy(base)).numpy()
    assert np.abs(ours_stack - ref_stack).max() < 1e-6
    jdet = J._detect_octave_batched(jnp.asarray(ref_stack), 4096,
                                    J.CONTRAST_THRESHOLD)
    stack = torch.from_numpy(ref_stack.copy())
    tdet = T._detect_octave(stack, 4096)
    valid = np.asarray(jdet["valid"])
    assert valid.sum() > 1000
    np.testing.assert_array_equal(tdet["valid"].numpy(), valid)
    for k in ("x", "y"):
        assert np.abs(tdet[k].numpy() - np.asarray(jdet[k]))[valid].max() < 2e-4
    ja, jv, jd = map(np.asarray, J._orient_describe_patch_batched(
        jnp.asarray(ref_stack), jdet))
    ta, tv, td = T._orient_and_describe_patch(
        stack, {k: torch.from_numpy(np.array(v)) for k, v in jdet.items()})
    both = valid[..., None] & jv
    np.testing.assert_array_equal(tv.numpy()[valid], jv[valid])
    assert np.degrees(np.abs(ta.numpy() - ja))[both].max() < 5e-3
    assert np.abs(td.numpy() - jd)[both].max() < 5e-5


# ---------------------------------------------------------------------------
# 2. Matching at capacity 8192 (the plain statistics on the CPU; the JAX
# package's scan over 1024-column tiles)


def _banks(descriptors, capacity=CAPACITY):
    bank = np.zeros((len(descriptors), capacity, 128), np.float32)
    mask = np.zeros((len(descriptors), capacity), bool)
    for i, d in enumerate(descriptors):
        bank[i, :len(d)], mask[i, :len(d)] = d, True
    return bank, mask


def _match_both(descriptors):
    """match_pairs_batch of both packages on both directions of the pair,
    each bank as its matcher uploads it (the JAX package's f32 on the CPU,
    the port's bf16)."""
    import jax.numpy as jnp

    from monocularsfm_torch.ops.matching import match_pairs_batch as T
    from monocularsfm_tpu.ops.matching import match_pairs_batch as J

    bank, mask = _banks(descriptors)
    ids = np.array([[0, 1], [1, 0]], np.int32)
    ref = np.asarray(J(jnp.asarray(bank), jnp.asarray(mask), jnp.asarray(ids)))
    ours = T(torch.from_numpy(bank).to(torch.bfloat16), torch.from_numpy(mask),
             torch.from_numpy(ids)).numpy()
    return ref, ours


@pytest.fixture(scope="module")
def matched(patch):
    return _match_both(patch[0][1])


def test_match_pairs_batch_at_capacity_8192(matched):
    """The two views' JAX descriptors at capacity 8192, both directions:
    idx_b equal in all 2 x 8192 entries (measured: equal, 3,328 matches
    each way)."""
    ref, ours = matched
    assert ref.shape == ours.shape == (2, CAPACITY)
    assert (ref >= 0).sum(1).min() > 1000
    np.testing.assert_array_equal(ours, ref)


def test_pair_auto_at_8192_by_4096(patch):
    """match_descriptors_pair_auto on an unequal pair: view 0's bank at
    8192 against the first 4096 rows of view 1's; idx_b equal to the JAX
    package's (its scan matcher off the TPU; measured: equal, 2,757
    matches)."""
    import jax.numpy as jnp

    from monocularsfm_torch.ops.matching import match_descriptors_pair_auto as T
    from monocularsfm_tpu.ops.matching import match_descriptors_pair_auto as J

    bank, mask = _banks(patch[0][1])
    a, ma = bank[0], mask[0]
    b, mb = bank[1, :4096], mask[1, :4096]
    ref = np.asarray(J(*(jnp.asarray(v) for v in (a, b, ma, mb))))
    ours = T(*(torch.from_numpy(v) for v in (a, b, ma, mb))).numpy()
    assert ref.shape == ours.shape == (CAPACITY,)
    assert (ref >= 0).sum() > 500
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.slow
def test_sift_gather_at_full_width(textured):
    """The same two views in the gather sampler (sample_mode "gather"):
    the same rule as the patch sampler, for the same reason (measured:
    5065/5065 and 5078/5078 keypoints, paired 100% and 99.96%, size/angle
    99.9th percentile 0.011 and maximum 0.086, descriptors 2.4e-4 and
    2.50e-3, one keypoint over each 320x240 tolerance)."""
    _holds_the_full_width_rule(*_extract_both(textured, "gather"))


@pytest.fixture(scope="module")
def multiplane():
    """Two 1280x960 views of the smoke's multi-plane scene (its seed and
    camera spacing), each with more than 10,000 keypoints before the cap:
    the default 8024 cuts both."""
    return render_multiplane_images(scene_seed=MP_SEED, num_cameras=2,
                                    width=WIDTH, height=HEIGHT,
                                    arc_deg=2 * MP_ARC_PER_VIEW)[0]


@pytest.fixture(scope="module")
def capped(multiplane):
    from monocularsfm_torch.ops import sift as T

    ref, ours = _extract_both(multiplane)
    uncut = T.SIFT(num_features=100_000, device="cpu").extract_batch(multiplane)
    return ref, ours, uncut


@pytest.mark.slow
def test_sift_at_the_8024_cap(capped):
    """`_select_top_features` cuts 10,119 and 10,008 keypoints to 8024.
    The port's cut output is the first 8024 rows of its uncut output, bit
    for bit (the top by size, the lower index first on ties: the two
    orientation slots of one keypoint tie).  Against the JAX package,
    measured: paired 99.90% and 100%, the last kept size 1.79680 against
    1.79767 (0.049%), size/angle 99.9th percentile 0.011 and maximum
    0.038, descriptors 3.5e-4 and 9.4e-4.

    The kept sets differ by 8 of 8024 keypoints in view 0, each a test
    that f32 noise settles: the port keeps three keypoints the JAX package
    rejects (at (887.2, 71.9) the edge test's ratio tr^2 r / ((r+1)^2 det)
    is 0.99981 on the JAX package's pyramid and 0.99954 on the port's, 1 at
    the threshold; at (883.1, 480.0) the refined contrast is 0.0133333,
    the threshold 0.04 / 3), which pushes the five smallest keypoints
    (sizes 1.79680-1.79767) past the cut; and two keypoints are refined
    0.054 and 0.018 px apart.  Every JAX keypoint the port does not keep
    is in the port's uncut output within 0.1 px."""
    ref, ours, uncut = capped
    for ka, kb, ku in zip(ref[0], ours[0], uncut[0]):
        assert len(ka) == len(kb) == 8024 < 9000 < len(ku)
        np.testing.assert_array_equal(kb, ku[:8024])
        assert abs(kb[-1, 2] - ka[-1, 2]) <= 1e-3 * ka[-1, 2]
        missing = _pair(ka, kb) < 0
        assert (_pair(ka[missing], ku, tol=0.1) >= 0).all()
    for db, du in zip(ours[1], uncut[1]):
        np.testing.assert_array_equal(db, du[:8024])
    paired, size_angle, desc = _differences(ref, ours)
    assert paired.min() >= 0.998, paired
    assert (size_angle > TOY_SIZE_ANGLE).mean() <= 1e-3
    assert (desc > TOY_DESC).mean() <= 1e-3
    assert np.percentile(size_angle, 99.9) < 0.02
    assert np.percentile(desc, 99.9) < 5e-4


@pytest.mark.slow
def test_match_pairs_batch_at_the_cap(capped):
    """Matching at capacity 8192 on the JAX package's 8024 descriptors of
    each multi-plane view, both directions: idx_b equal (measured: equal,
    5,605 matches each way)."""
    ref, ours = _match_both(capped[0][1])
    assert (ref >= 0).sum(1).min() > 1000
    np.testing.assert_array_equal(ours, ref)


# ---------------------------------------------------------------------------
# 3. F-RANSAC at full match counts


@pytest.mark.slow
def test_f_ransac_at_full_match_counts(capped):
    """Geometric verification of the multi-plane pair as the matcher runs
    it (features/matching.py::_verify_batch): the JAX package's matches of
    both directions (5,605 each), 8 pairs padded as the matcher pads them,
    capacity _pad_pow2(matches, 512), 2048 hypotheses, the JAX matcher's
    draws.  The estimator's first round: the same success flags, inlier
    masks agreeing on 99% of the matches (measured 100%: every match an
    inlier on both sides) and, over the inliers, each F's Sampson distance
    within 1 px of the other's (measured 0.49 and 0.26 px); then
    `_verify_batch` with its adaptive rounds: masks agreeing on 99%.

    F itself is not held elementwise: both packages take the smallest
    eigenvector of the f32 normal matrix of all 5,605 inliers, and at this
    pair's 3.1-degree baseline its two smallest eigenvalues lie within the
    f32 noise of the matrix's sums, so the unit F differs by up to 6.5e-3
    (the two directions' Sampson means 0.0285 against 0.0209 px^2, and
    0.0209 against 0.0280: each package is ahead in one).  At a 12.5-degree
    baseline the same pair's F agreed to 2.3e-5, except where a borderline
    match swapped the winner (3,654 against 3,653 inliers), the standing
    difference of ROADMAP section 3."""
    import jax
    import jax.numpy as jnp

    from monocularsfm_torch.config import MatchingConfig as TC
    from monocularsfm_torch.estimators import estimate_fundamental_ransac_batch as TF
    from monocularsfm_torch.estimators.fundamental import sampson_distance
    from monocularsfm_torch.features.matching import _MatcherBase as TM
    from monocularsfm_tpu.config import MatchingConfig as JC
    from monocularsfm_tpu.estimators import estimate_fundamental_ransac_batch as JF
    from monocularsfm_tpu.features.matching import _MatcherBase as JM
    from monocularsfm_tpu.ops.matching import matches_to_pairs

    (kps, descs), _, _ = capped
    idx_b = _match_both(descs)[0]
    uv_pairs = []
    for (a, b), row in zip(((0, 1), (1, 0)), idx_b):
        i, j = matches_to_pairs(row)
        uv_pairs.append((kps[a][i, :2], kps[b][j, :2]))
    n = [len(u) for u, _ in uv_pairs]
    assert min(n) > 1000
    cfg = JC()
    B, M = 8, cfg.ransac_iterations
    cap = 512
    while cap < max(n):
        cap *= 2
    x1 = np.zeros((B, cap, 2), np.float32)
    x2 = np.zeros((B, cap, 2), np.float32)
    m = np.zeros((B, cap), bool)
    for p, (u1, u2) in enumerate(uv_pairs):
        x1[p, :len(u1)], x2[p, :len(u1)], m[p, :len(u1)] = u1, u2, True
    _, key = jax.random.split(jax.random.PRNGKey(1234))
    ref = JF(key, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(m),
             threshold_px=cfg.ransac_threshold_px, num_hyps=M)
    ours = TF(JaxMatchDraws()((B, M, cap)), *map(torch.from_numpy, (x1, x2, m)),
              threshold_px=cfg.ransac_threshold_px)
    np.testing.assert_array_equal(ours["success"].numpy(), np.asarray(ref["success"]))
    for p in range(len(uv_pairs)):
        inl_ref = np.asarray(ref["inliers"][p])
        inl = ours["inliers"][p].numpy()
        assert (inl == inl_ref)[m[p]].mean() >= 0.99
        both = torch.from_numpy(inl & inl_ref)
        a, b = (x[p][both] for x in map(torch.from_numpy, (x1, x2)))
        d_ref, d_ours = (sampson_distance(torch.from_numpy(np.asarray(F)), a, b).sqrt()
                         for F in (ref["F"][p], ours["F"][p]))
        assert (d_ref - d_ours).abs().max() < 1.0

    tm = TM(TC(), device="cpu")
    tm._draw = JaxMatchDraws()
    for a, b in zip(JM(JC())._verify_batch(uv_pairs), tm._verify_batch(uv_pairs)):
        assert len(a) == len(b) > 1000
        assert (a == b).mean() >= 0.99


# ---------------------------------------------------------------------------
# 4. The MapBuilder past the dense-to-PCG switch

RING_CAMERAS, RING_POINTS, RING_OVERLAP = 56, 2000, 8


def _ring_config(module_config, scene):
    cfg = module_config.SfMConfig()
    cfg.camera.fx, cfg.camera.fy = scene.K[0, 0], scene.K[1, 1]
    cfg.camera.cx, cfg.camera.cy = scene.K[0, 2], scene.K[1, 2]
    return cfg


def _centres(builder, ids):
    m = builder.map
    return np.array([-m.images[i].R.T @ m.images[i].t for i in ids])


@pytest.fixture(scope="module")
def ring_builds(tmp_path_factory):
    """56 cameras on a 300-degree arc around 2,000 points, matched as a
    sequential matcher with an overlap of 8 would pair them; both builders
    on the same correspondences, the port with the JAX package's draws."""
    from monocularsfm_torch import config as tc
    from monocularsfm_torch.reconstruction import MapBuilder as TB
    from monocularsfm_tpu import config as jc
    from monocularsfm_tpu.reconstruction import MapBuilder as JB

    root = tmp_path_factory.mktemp("ring")
    scene = camera_ring_scene(num_cameras=RING_CAMERAS, num_points=RING_POINTS,
                              seed=21, arc_deg=300.0)
    keypoints, matches = scene_to_matches(scene)
    matches = {p: m for p, m in matches.items() if p[1] - p[0] <= RING_OVERLAP}
    out = {}
    for name, B, mod in (("jax", JB, jc), ("torch", TB, tc)):
        b = B(_ring_config(mod, scene), **({"device": "cpu"} if name == "torch" else {}))
        b._log = lambda *a: None
        if name == "torch":
            b.initializer._draw = JaxDraws(42)
            b.registrant._draw = JaxDraws(7)
        b.enable_metrics(root / f"{name}.jsonl")
        b.setup(matches, keypoints)
        out[name] = (b, b.do_build())
        b._metrics_fh.close()
    events = {n: [json.loads(line) for line in (root / f"{n}.jsonl").read_text().splitlines()]
              for n in out}
    return scene, out, events


@pytest.mark.slow
def test_mapbuilder_past_the_pcg_switch(ring_builds):
    """Measured on the CPU: both register all 56 cameras in the same order
    with the same events; global BA dense 27 times up to 48 images, then
    PCG at 52 and 56 in both; 2,021 points on both sides, mean reprojection
    errors 7e-8 px apart; camera centres 8.8e-7 of the mean radius apart
    after a similarity alignment (each 1.1e-4 from the truth); PnP inliers
    equal for 54 of 56 registrations, within 0.6% for the other two (a
    borderline correspondence in f32)."""
    scene, out, events = ring_builds
    (bj, sj), (bt, st) = out["jax"], out["torch"]
    ids = sorted(bj.map.registered_ids)
    assert sorted(bt.map.registered_ids) == ids
    assert len(ids) == RING_CAMERAS
    assert abs(st.num_points3D - sj.num_points3D) <= 0.01 * sj.num_points3D
    assert abs(st.mean_reprojection_error - sj.mean_reprojection_error) < 1e-3
    cj, ct = _centres(bj, ids), _centres(bt, ids)
    gt = np.array([-scene.R[i].T @ scene.t[i] for i in ids])
    radius = np.linalg.norm(gt - gt.mean(0), axis=1).mean()
    assert similarity_align(ct, cj)[1] < 1e-4 * radius
    for c in (cj, ct):
        assert similarity_align(c, gt)[1] < 1e-3 * radius
    ej, et = events["jax"], events["torch"]
    assert [(e["event"], e.get("image_id"), e.get("solver")) for e in et] == \
        [(e["event"], e.get("image_id"), e.get("solver")) for e in ej]
    assert "pcg" in {e.get("solver") for e in et}
    for a, b in zip(ej, et):
        if a["event"] == "register":
            assert abs(b["inliers"] - a["inliers"]) <= 0.01 * a["inliers"]


# ---------------------------------------------------------------------------
# 5. The pipeline at full width: 16 views at 1280x960 from PNGs

PIPE_VIEWS = 16


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    """Both packages' cmd_extract, cmd_match and cmd_reconstruct on the
    same 16 PNGs (the smoke's multi-plane scene and camera spacing) at the
    default configuration, each into its own database; the port with the
    JAX package's draws (matcher, initializer, registrant)."""
    from monocularsfm_torch import cli as tcli, config as tconf
    from monocularsfm_torch.features import matching as TM
    from monocularsfm_torch.utils.png import write_png
    from monocularsfm_tpu import cli as jcli, config as jconf

    root = tmp_path_factory.mktemp("full_width_pipeline")
    images = root / "images"
    images.mkdir()
    imgs, K, R, t = render_multiplane_images(
        scene_seed=MP_SEED, num_cameras=PIPE_VIEWS, width=WIDTH, height=HEIGHT,
        arc_deg=PIPE_VIEWS * MP_ARC_PER_VIEW)
    for i, im in enumerate(imgs):
        write_png(images / f"frame{i:04d}.png", im)
    quiet = lambda *a: None  # noqa: E731
    out = {}
    for name, conf in (("jax", jconf), ("torch", tconf)):
        cfg = conf.SfMConfig(images_path=str(images),
                             database_path=str(root / f"{name}.db"),
                             output_path=str(root / f"{name}_out"))
        cfg.camera.fx, cfg.camera.fy = float(K[0, 0]), float(K[1, 1])
        cfg.camera.cx, cfg.camera.cy = float(K[0, 2]), float(K[1, 2])
        if name == "jax":
            cfg.parallel.shard_matching = False
            jcli.cmd_extract(cfg, log=quiet)
            jcli.cmd_match(cfg, log=quiet)
            out[name] = jcli.cmd_reconstruct(cfg, log=quiet)
            continue
        draws = JaxMatchDraws()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(TM._MatcherBase, "_draw", lambda self, shape: draws(shape))
            patch_engine_draws(mp)
            tcli.cmd_extract(cfg, device="cpu", log=quiet)
            tcli.cmd_match(cfg, device="cpu", log=quiet)
            out[name] = tcli.cmd_reconstruct(cfg, device="cpu", log=quiet)
    return out, (K, R, t), root


@pytest.mark.slow
def test_pipeline_at_full_width(pipelines):
    """Measured on the CPU: 8024 keypoints in every view on both sides (the
    cap cuts each), all 120 brute pairs verified on both, 522,742 against
    522,731 matches (each pair within 0.12%, 4 matches at most); 16 of 16
    registered on both, 12,036 against 12,023 points, mean reprojection
    0.14170 against 0.14150 px; camera centres 0.00014% of the scene
    diagonal apart after a similarity alignment, 0.0050% and 0.0054% from
    the truth."""
    from monocularsfm_tpu.database import Database

    out, (K, R, t), root = pipelines
    matches = {}
    for name in ("jax", "torch"):
        db = Database(str(root / f"{name}.db"))
        try:
            for i in db.read_all_images():
                assert len(db.read_keypoints(i)) == 8024
            matches[name] = {p: len(m) for p, m in db.read_all_matches().items()}
        finally:
            db.close()
    mj, mt = matches["jax"], matches["torch"]
    assert set(mt) == set(mj) and len(mj) == PIPE_VIEWS * (PIPE_VIEWS - 1) // 2
    assert {p for p, n in mt.items() if n} == {p for p, n in mj.items() if n}
    for p, n in mj.items():
        assert abs(mt[p] - n) <= 0.01 * n, (p, n, mt[p])

    bj, bt = out["jax"], out["torch"]
    names = {}
    for name, b in (("jax", bj), ("torch", bt)):
        names[name] = {b.map.images[i].name: b.map.images[i] for i in b.map.registered_ids}
    assert names["torch"].keys() == names["jax"].keys()
    assert len(names["jax"]) == PIPE_VIEWS
    sj, st = bj.map.statistics(), bt.map.statistics()
    assert abs(st.num_points3D - sj.num_points3D) <= 0.01 * sj.num_points3D
    assert abs(st.mean_reprojection_error - sj.mean_reprojection_error) < 0.01
    order = sorted(names["jax"])
    centres = {name: np.array([-by[n].R.T @ by[n].t for n in order])
               for name, by in names.items()}
    gt = np.array([-R[int(n[5:9])].T @ t[int(n[5:9])] for n in order])
    diag = float(np.linalg.norm(np.ptp(gt, axis=0)))
    assert similarity_align(centres["torch"], centres["jax"])[1] < 1e-4 * diag
    for c in centres.values():
        assert similarity_align(c, gt)[1] < 1e-3 * diag
