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
def extracted():
    imgs = render_textured_images(num_cameras=2, width=320, height=240,
                                  arc_deg=30.0, scene_seed=5)[0]
    ref = J.SIFT(num_features=512).extract_batch(imgs)
    ours = T.SIFT(num_features=512, device="cpu").extract_batch(imgs)
    return ref, ours


def _pair(ka, kb):
    """For each reference keypoint, the port's keypoint at the same position
    and orientation (or -1)."""
    dxy = np.abs(ka[:, None, :2] - kb[None, :, :2]).max(-1)
    dang = np.abs((ka[:, None, 3] - kb[None, :, 3] + 180.0) % 360.0 - 180.0)
    cost = dxy + (dang > 0.5) * 1e3
    j = cost.argmin(1)
    return np.where(cost[np.arange(len(ka)), j] < KP_TOL, j, -1)


def test_keypoint_counts_within_one_percent(extracted):
    (kr, _), (ko, _) = extracted
    for a, b in zip(kr, ko):
        assert len(a) > 300
        assert abs(len(a) - len(b)) <= 0.01 * len(a)


def test_keypoints_and_descriptors_agree(extracted):
    (kr, dr), (ko, do) = extracted
    for ka, da, kb, db in zip(kr, dr, ko, do):
        j = _pair(ka, kb)
        ok = j >= 0
        assert ok.mean() >= PAIRED, ok.mean()
        assert np.abs(ka[ok, 2:] - kb[j[ok], 2:]).max() < 0.05  # size, angle
        assert np.abs(da[ok] - db[j[ok]]).max() < DESC_TOL


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
