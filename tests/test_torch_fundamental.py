"""Port's batched F-RANSAC against the JAX one, with the JAX draws injected."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from monocularsfm_tpu.estimators import estimate_fundamental_ransac_batch as jax_f
from monocularsfm_torch.estimators import estimate_fundamental_ransac_batch as torch_f
from monocularsfm_torch.estimators.ransac import rounds_to_confidence
from monocularsfm_torch.utils.synthetic import camera_ring_scene

NUM_HYPS = 512


def _correspondences(seed, n=300, outlier_frac=0.3, cap=512):
    scene = camera_ring_scene(num_cameras=2, num_points=n, noise_px=0.3,
                              seed=seed, arc_deg=30.0)
    rng = np.random.default_rng(seed)
    uv1 = scene.observations[0].astype(np.float32)
    uv2 = scene.observations[1].astype(np.float32)
    bad = rng.random(n) < outlier_frac
    uv2[bad] = rng.uniform(0, [scene.width, scene.height],
                           size=(bad.sum(), 2)).astype(np.float32)
    x1 = np.zeros((cap, 2), np.float32)
    x2 = np.zeros((cap, 2), np.float32)
    m = np.zeros(cap, bool)
    x1[:n], x2[:n], m[:n] = uv1, uv2, True
    return x1, x2, m


def test_f_ransac_matches_reference_with_injected_draws():
    pairs = [_correspondences(s) for s in (1, 2, 3)]
    x1, x2, m = (np.stack(v) for v in zip(*pairs))
    key = jax.random.PRNGKey(7)
    ref = jax_f(key, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(m),
                threshold_px=3.0, num_hyps=NUM_HYPS)
    # The draws the reference makes inside: split per pair, then uniform.
    keys = jax.random.split(key, len(pairs))
    u = np.stack([np.asarray(jax.random.uniform(k, (NUM_HYPS, x1.shape[1])))
                  for k in keys])
    out = torch_f(torch.from_numpy(u), torch.from_numpy(x1),
                  torch.from_numpy(x2), torch.from_numpy(m), threshold_px=3.0)

    inl_ref = np.asarray(ref["inliers"])
    inl = out["inliers"].numpy()
    for p in range(len(pairs)):
        valid = m[p]
        agree = (inl_ref[p][valid] == inl[p][valid]).mean()
        assert agree >= 0.99, (p, agree)
        assert inl[p].sum() > 0.5 * valid.sum()
        Fr = np.asarray(ref["F"][p])
        Ft = out["F"][p].numpy()
        err = min(np.abs(Fr - Ft).max(), np.abs(Fr + Ft).max())  # up to sign
        assert err < 1e-3, (p, err)
    np.testing.assert_array_equal(np.asarray(ref["success"]),
                                  out["success"].numpy())


def test_rounds_to_confidence_matches_reference():
    from monocularsfm_tpu.estimators import rounds_to_confidence as ref

    for count, valid in ((10, 100), (60, 100), (99, 100), (0, 0)):
        assert rounds_to_confidence(0.99, count, valid, 8, 2048) == \
            ref(0.99, count, valid, 8, 2048)
