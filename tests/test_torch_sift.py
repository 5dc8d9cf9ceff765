"""The port's SIFT against the JAX package's, both on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocularsfm_torch.ops import sift as T
from monocularsfm_torch.utils.synthetic import render_textured_images
from monocularsfm_tpu.ops import sift as J

KP_TOL = 0.01      # px: both sides refine the same extrema in f32
DESC_TOL = 2e-3    # f16 descriptors, f32 sums in another order
PAIRED = 0.99


@pytest.fixture(scope="module")
def rendered():
    return render_textured_images(num_cameras=2, width=320, height=240,
                                  arc_deg=30.0, scene_seed=5)[0]


def _both(imgs, sample_mode):
    ref = J.SIFT(num_features=512, sample_mode=sample_mode).extract_batch(imgs)
    ours = T.SIFT(num_features=512, sample_mode=sample_mode,
                  device="cpu").extract_batch(imgs)
    return ref, ours


@pytest.fixture(scope="module")
def extracted(rendered):
    return _both(rendered, "patch")


@pytest.fixture(scope="module")
def extracted_gather(rendered):
    return _both(rendered, "gather")


def _pair(ka, kb):
    """For each reference keypoint, the port's keypoint at the same position
    and orientation (or -1)."""
    dxy = np.abs(ka[:, None, :2] - kb[None, :, :2]).max(-1)
    dang = np.abs((ka[:, None, 3] - kb[None, :, 3] + 180.0) % 360.0 - 180.0)
    cost = dxy + (dang > 0.5) * 1e3
    j = cost.argmin(1)
    return np.where(cost[np.arange(len(ka)), j] < KP_TOL, j, -1)


def _counts_within_one_percent(extracted):
    (kr, _), (ko, _) = extracted
    for a, b in zip(kr, ko):
        assert len(a) > 300
        assert abs(len(a) - len(b)) <= 0.01 * len(a)


def _keypoints_and_descriptors_agree(extracted):
    (kr, dr), (ko, do) = extracted
    for ka, da, kb, db in zip(kr, dr, ko, do):
        j = _pair(ka, kb)
        ok = j >= 0
        assert ok.mean() >= PAIRED, ok.mean()
        assert np.abs(ka[ok, 2:] - kb[j[ok], 2:]).max() < 0.05  # size, angle
        assert np.abs(da[ok] - db[j[ok]]).max() < DESC_TOL


def test_keypoint_counts_within_one_percent(extracted):
    _counts_within_one_percent(extracted)


def test_keypoints_and_descriptors_agree(extracted):
    _keypoints_and_descriptors_agree(extracted)


def test_gather_keypoint_counts_within_one_percent(extracted_gather):
    _counts_within_one_percent(extracted_gather)


def test_gather_keypoints_and_descriptors_agree(extracted_gather):
    _keypoints_and_descriptors_agree(extracted_gather)


def test_gather_matches_patch_inside_the_border(rendered):
    """The port's two samplers under the reference's rule
    (tests/test_sift.py::test_patch_path_matches_gather_path): they differ
    near the border (the patch replicates the edge, the gather clamps) and
    may flip marginal secondary orientations, so keypoints inside the
    descriptor's reach pair by (x, y, angle), 90% of them at least, and
    their descriptors agree within 5e-3."""
    out = {m: T.SIFT(num_features=800, k_per_octave=512, sample_mode=m,
                     device="cpu").extract_batch(rendered[:1])
           for m in ("gather", "patch")}
    (ka,), (da,) = out["gather"]
    (kb,), (db_,) = out["patch"]
    H, W = rendered.shape[1:3]

    def interior(kp):
        margin = 4.0 * kp[:, 2] + 6.0
        return ((kp[:, 0] > margin) & (kp[:, 0] < W - margin)
                & (kp[:, 1] > margin) & (kp[:, 1] < H - margin))

    def key(kp, i):
        return (round(float(kp[i, 0]), 2), round(float(kp[i, 1]), 2),
                round(float(kp[i, 3]), 0))

    map_a = {key(ka, i): i for i in np.nonzero(interior(ka))[0]}
    map_b = {key(kb, i): i for i in np.nonzero(interior(kb))[0]}
    common = sorted(set(map_a) & set(map_b))
    assert len(common) >= 0.9 * max(len(map_a), len(map_b)) > 100
    ia = np.asarray([map_a[c] for c in common])
    ib = np.asarray([map_b[c] for c in common])
    assert np.abs(da[ia] - db_[ib]).max() < 5e-3


def test_bilinear_grads_match_reference():
    """The gather sampler's packed table and its bilinear samples against
    the reference's on random data (tests/test_sift.py's construction)."""
    rng = np.random.default_rng(0)
    ssz, hsz, wsz = 3, 96, 128
    vol = rng.normal(size=(ssz, hsz, wsz)).astype(np.float32)
    gx = np.zeros_like(vol)
    gx[:, :, 1:-1] = 0.5 * (vol[:, :, 2:] - vol[:, :, :-2])
    gy = np.zeros_like(vol)
    gy[:, 1:-1, :] = 0.5 * (vol[:, 2:, :] - vol[:, :-2, :])
    gxf, gyf = gx.ravel(), gy.ravel()
    shift = lambda v: np.concatenate([v[1:], v[:1]])  # noqa: E731
    pack = np.stack([gxf, shift(gxf), gyf, shift(gyf)], axis=1)
    ours_pack = T._gradient_pack(torch.from_numpy(vol[None]))
    np.testing.assert_array_equal(ours_pack.numpy(), pack)

    k = 8
    xk = rng.uniform(34, wsz - 34, size=k).astype(np.float32)
    yk = rng.uniform(34, hsz - 34, size=k).astype(np.float32)
    si = rng.integers(0, ssz, size=k).astype(np.int32)
    off = rng.uniform(-40, 40, size=(k, 16)).astype(np.float32)  # some clamp
    sx = xk[:, None] + off
    sy = yk[:, None] + off[:, ::-1]
    ref = jax.vmap(lambda s, yy, xx: J._bilinear_grads(
        jnp.asarray(pack), (ssz, hsz, wsz), s, xx, yy))(
        jnp.asarray(si), jnp.asarray(sy), jnp.asarray(sx))
    ours = T._bilinear_grads(ours_pack, (ssz, hsz, wsz),
                             torch.from_numpy(si.astype(np.int64))[:, None],
                             torch.from_numpy(sx), torch.from_numpy(sy.copy()))
    for r, o in zip(ref, ours):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5)


def test_upsample_matches_jax_resize():
    rng = np.random.default_rng(0)
    x = rng.random((2, 37, 53)).astype(np.float32)
    ref = np.asarray(jax.vmap(lambda im: jax.image.resize(
        im, (74, 106), method="linear"))(jnp.asarray(x)))
    ours = T._upsample2x(torch.from_numpy(x)).numpy()
    assert np.abs(ours - ref).max() < 1e-6


def test_detect_octave_matches_reference():
    img = render_textured_images(num_cameras=1, width=128, height=96,
                                 scene_seed=2)[0].astype(np.float32) / 255.0
    base = np.array(J._build_octave_batched_conv(jnp.asarray(img)))
    ref = J._detect_octave(jnp.asarray(base[0]), 64)
    ours = T._detect_octave(torch.from_numpy(base), 64)
    np.testing.assert_array_equal(np.asarray(ref["valid"]), ours["valid"][0].numpy())
    v = np.asarray(ref["valid"])
    assert v.sum() > 5
    for k in ("x", "y", "scale", "response"):
        np.testing.assert_allclose(np.asarray(ref[k])[v], ours[k][0].numpy()[v],
                                   atol=1e-4, err_msg=k)


def test_extractor_sample_mode_gather_extracts_as_reference(rendered):
    """ExtractionConfig.sample_mode reaches the port's SIFT as it reaches
    the reference's: with "gather" both extractors give the same keypoints
    and descriptors."""
    from monocularsfm_torch.config import ExtractionConfig as TC
    from monocularsfm_torch.features.extraction import FeatureExtractor as TE
    from monocularsfm_tpu.config import ExtractionConfig as JC
    from monocularsfm_tpu.features.extraction import FeatureExtractor as JE

    kw = dict(num_features=512, sample_mode="gather")
    kj, _, dj = JE(JC(**kw)).extract_one(rendered[0])
    kt, _, dt = TE(TC(**kw), device="cpu").extract_one(rendered[0])
    _counts_within_one_percent((([kj], [dj]), ([kt], [dt])))
    _keypoints_and_descriptors_agree((([kj], [dj]), ([kt], [dt])))
