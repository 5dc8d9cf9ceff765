"""The port's bundle adjustment against the JAX package's, on the CPU.

The problems are the repo bench's camera-ring recipe at its smoke shapes
(8 cameras, 1500 points, track 4; PCG: 16 cameras, 2000 points, track 4),
built from one set of numpy arrays for both packages."""

import numpy as np
import pytest
import torch

from monocularsfm_torch.optim import ba as TB
from monocularsfm_torch.utils.synthetic import camera_ring_scene

COST0_RTOL, COST_RTOL, STATE_TOL = 1e-6, 1e-4, 1e-3


def ring_arrays(cams, points, track, seed=2, row_width=None):
    """The bench's ring problem as numpy arrays (bench.py _ring_problem);
    with `row_width`, every track is split into rows of that width
    (sorted point_rows, as the map's BA bridge builds them)."""
    from monocularsfm_torch.geometry import angle_axis_to_matrix

    scene = camera_ring_scene(num_cameras=cams, num_points=points,
                              noise_px=0.5, seed=seed)
    rng = np.random.default_rng(0)
    vis = scene.visible.T
    keys = rng.random(vis.shape) + np.where(vis, 0.0, 10.0)
    order = np.argpartition(keys, min(track, vis.shape[1] - 1), axis=1)
    obs_cam = order[:, :track].astype(np.int32)
    obs_valid = np.take_along_axis(vis, order[:, :track], axis=1)
    obs_uv = scene.observations[obs_cam, np.arange(points)[:, None]].astype(np.float32)
    aa = rng.normal(scale=0.01, size=(cams, 3))
    R = np.einsum("cij,cjk->cik",
                  angle_axis_to_matrix(torch.from_numpy(aa).float()).double().numpy(),
                  scene.R)
    t = scene.t + rng.normal(scale=0.02, size=(cams, 3))
    X = scene.points + rng.normal(scale=0.02, size=scene.points.shape)
    cam_const = np.zeros(cams, bool)
    cam_const[0] = True
    K4 = np.array([scene.K[0, 0], scene.K[1, 1], scene.K[0, 2], scene.K[1, 2]],
                  np.float32)
    kw = {}
    if row_width is not None:
        nrow = -(-track // row_width)
        obs_cam = obs_cam.reshape(points * nrow, row_width)
        obs_uv = obs_uv.reshape(points * nrow, row_width, 2)
        point_valid = obs_valid.any(axis=1)
        obs_valid = obs_valid.reshape(points * nrow, row_width)
        kw = dict(point_valid=point_valid,
                  point_rows=np.repeat(np.arange(points), nrow).astype(np.int32))
    return (K4, R, t, X, obs_cam, obs_uv, obs_valid, cam_const), kw


def both_problems(*args, **kwargs):
    from monocularsfm_tpu.optim import make_bundle_problem as j_make

    arrays, kw = ring_arrays(*args, **kwargs)
    return j_make(*arrays, **kw), TB.make_bundle_problem(*arrays, **kw)


def _compare(ref, out, same_iterations=True):
    c0j, c0t = float(ref["cost_initial"]), float(out["cost_initial"])
    assert abs(c0t - c0j) <= COST0_RTOL * c0j, (c0t, c0j)
    cj, ct = float(ref["cost_final"]), float(out["cost_final"])
    assert abs(ct - cj) <= COST_RTOL * cj, (ct, cj)
    assert ct < c0t
    if same_iterations:
        assert int(out["iterations"]) == int(ref["iterations"])
    for k in ("R", "t", "X"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=STATE_TOL, err_msg=k)
    assert abs(float(out["rmse_final"]) - float(ref["rmse_final"])) <= 1e-3
    assert abs(float(out["mean_reproj_error"])
               - float(ref["mean_reproj_error"])) <= 1e-3


@pytest.mark.parametrize("refine_focal", [False, True])
def test_dense_matches_reference(refine_focal):
    from monocularsfm_tpu.optim import bundle_adjust as j_ba

    pj, pt = both_problems(8, 1500, 4)
    kw = dict(max_iterations=3, refine_focal=refine_focal)
    ref = j_ba(pj, **kw)
    out = TB.bundle_adjust(pt, device="cpu", **kw)
    _compare(ref, out)
    if refine_focal:
        np.testing.assert_allclose(out["K"].numpy(), np.asarray(ref["K"]),
                                   rtol=1e-5)


def test_dense_runs_to_convergence_like_reference():
    from monocularsfm_tpu.optim import bundle_adjust as j_ba

    pj, pt = both_problems(8, 1500, 4)
    ref = j_ba(pj, max_iterations=30)
    out = TB.bundle_adjust(pt, max_iterations=30)
    # At the noise floor a step's cost change is a few f32 ulps of the sum,
    # so which late step is accepted, and when the 1e-6 function tolerance
    # fires, depends on summation order: compare where both end.
    _compare(ref, out, same_iterations=False)
    assert out["converged"] and bool(ref["converged"])


def test_pcg_with_split_rows_matches_reference():
    from monocularsfm_tpu.optim import bundle_adjust as j_ba

    pj, pt = both_problems(16, 2000, 4, row_width=2)
    assert pt.point_rows is not None and pt.obs_cam.shape == (4000, 2)
    kw = dict(max_iterations=2, solve_mode="pcg", pcg_iters=5)
    ref = j_ba(pj, **kw)
    out = TB.bundle_adjust(pt, **kw)
    _compare(ref, out)
    assert 0 < out["cg_steps"] <= 10


def test_pcg_and_dense_agree_on_one_problem():
    _, dense = both_problems(8, 1500, 4)
    _, split = both_problems(8, 1500, 4, row_width=2)
    a = TB.bundle_adjust(dense, max_iterations=20)
    b = TB.bundle_adjust(split, max_iterations=20, solve_mode="pcg", pcg_iters=50)
    assert abs(float(a["rmse_final"]) - float(b["rmse_final"])) <= 2e-3


def test_problems_are_refused_off_their_device_and_unsorted():
    _, pt = both_problems(8, 300, 4)
    with pytest.raises(ValueError, match="lies on"):
        TB.bundle_adjust(pt, device="meta", max_iterations=1)
    _, split = both_problems(8, 300, 4, row_width=2)
    split.point_rows = split.point_rows.flip(0)
    with pytest.raises(ValueError, match="sorted point_rows"):
        TB.bundle_adjust(split, solve_mode="pcg", max_iterations=1)
    with pytest.raises(ValueError, match="identity point_rows"):
        TB.bundle_adjust(split, solve_mode="dense", max_iterations=1)
