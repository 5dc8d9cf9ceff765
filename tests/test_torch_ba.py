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


def flipped_problems(cams, points, track, row_width):
    """The split-row ring with its observation rows in reverse order, so
    that point_rows descends: the same problem, rows unsorted."""
    from monocularsfm_tpu.optim import make_bundle_problem as j_make

    arrays, kw = ring_arrays(cams, points, track, row_width=row_width)
    arrays = arrays[:4] + tuple(a[::-1].copy() for a in arrays[4:7]) + arrays[7:]
    kw["point_rows"] = kw["point_rows"][::-1].copy()
    return j_make(*arrays, **kw), TB.make_bundle_problem(*arrays, **kw)


def test_problems_are_refused_off_their_device_and_unsorted():
    """Off its device a problem is refused; with unsorted split rows the
    PCG solver runs (the reference takes them through its flash path) and
    the dense solver refuses them, as the reference does."""
    from monocularsfm_tpu.optim import bundle_adjust as j_ba

    _, pt = both_problems(8, 300, 4)
    with pytest.raises(ValueError, match="lies on"):
        TB.bundle_adjust(pt, device="meta", max_iterations=1)
    pj, split = flipped_problems(8, 300, 4, row_width=2)
    assert bool((split.point_rows[1:] < split.point_rows[:-1]).any())
    kw = dict(solve_mode="pcg", max_iterations=3, pcg_iters=10)
    ref = float(j_ba(pj, **kw)["rmse_final"])
    out = float(TB.bundle_adjust(split, **kw)["rmse_final"])
    assert abs(out - ref) <= 1e-4 * ref, (out, ref)
    _, in_order = both_problems(8, 300, 4, row_width=2)
    sorted_rmse = float(TB.bundle_adjust(in_order, **kw)["rmse_final"])
    assert abs(out - sorted_rmse) <= 1e-4 * sorted_rmse, (out, sorted_rmse)
    with pytest.raises(ValueError, match="identity point_rows"):
        TB.bundle_adjust(split, solve_mode="dense", max_iterations=1)


@pytest.mark.parametrize("mode", ["dense", "pcg"])
def test_segmented_solve_walks_the_same_iterates(ring_scene, mode):
    """dispatch_iters splits the solve into segments that resume from the
    last one's state: the same iterations, convergence, cost and points as
    one segment, on the reference's own problem and rule
    (tests/test_bundle_adjustment.py::test_segmented_dispatch_identical)."""
    from test_bundle_adjustment import _build_problem

    pj = _build_problem(ring_scene, noise_px=0.3, perturb=0.7)
    pt = TB.make_bundle_problem(*(np.array(getattr(pj, f)) for f in (
        "K", "R", "t", "X", "obs_cam", "obs_uv", "obs_valid", "cam_const")),
        cam_valid=np.array(pj.cam_valid), point_valid=np.array(pj.point_valid))
    kw = dict(max_iterations=21, solve_mode=mode)
    if mode == "pcg":
        kw["pcg_iters"] = 40
    mono = TB.bundle_adjust(pt, **kw)
    seg = TB.bundle_adjust(pt, dispatch_iters=3, **kw)
    assert seg["iterations"] == mono["iterations"] > 3
    assert seg["converged"] == mono["converged"]
    assert seg["cg_steps"] == mono["cg_steps"]
    np.testing.assert_allclose(float(seg["cost_final"]),
                               float(mono["cost_final"]), rtol=1e-6)
    np.testing.assert_allclose(seg["X"].numpy(), mono["X"].numpy(), atol=1e-6)
    assert float(seg["cost_initial"]) == float(mono["cost_initial"])
    # A solve resumed by hand from an earlier result's state.
    part = TB.bundle_adjust(pt, **dict(kw, max_iterations=3))
    state = tuple(part[k] for k in ("K", "R", "t", "X", "radius", "cost_final",
                                    "iterations", "converged"))
    rest = TB.bundle_adjust(pt, init_state=state, **kw)
    assert rest["iterations"] == mono["iterations"]
    np.testing.assert_allclose(rest["X"].numpy(), mono["X"].numpy(), atol=1e-6)


@pytest.mark.parametrize("mode", ["dense", "pcg"])
def test_segmented_solve_matches_reference_segmented(mode):
    from monocularsfm_tpu.optim import bundle_adjust as j_ba

    if mode == "dense":
        pj, pt = both_problems(8, 1500, 4)
        kw = dict(max_iterations=3, dispatch_iters=2)
    else:
        pj, pt = both_problems(16, 2000, 4, row_width=2)
        kw = dict(max_iterations=3, dispatch_iters=2, solve_mode="pcg",
                  pcg_iters=5)
    _compare(j_ba(pj, **kw), TB.bundle_adjust(pt, **kw))


def test_reference_solver_keywords():
    """The reference's solver keywords run unchanged: schur_chunk sets the
    dense build's chunk; the cached-PCG capacities change nothing here but
    are refused where the reference refuses them."""
    from monocularsfm_tpu.optim import bundle_adjust as j_ba

    _, pt = both_problems(8, 300, 4)
    a = TB.bundle_adjust(pt, max_iterations=3)
    b = TB.bundle_adjust(pt, max_iterations=3, schur_chunk=64)
    np.testing.assert_allclose(float(b["cost_final"]), float(a["cost_final"]),
                               rtol=1e-5)
    pj, split = both_problems(8, 300, 4, row_width=2)
    kw = dict(solve_mode="pcg", max_iterations=2, pcg_cached=True)
    for solve in (lambda **k: j_ba(pj, **k), lambda **k: TB.bundle_adjust(split, **k)):
        with pytest.raises(ValueError, match="pcg_max_rows=1 too small"):
            solve(**kw)
        with pytest.raises(ValueError, match="pcg_max_blocks=1 too small"):
            solve(pcg_max_rows=2, pcg_max_blocks=1, **kw)
    plain = TB.bundle_adjust(split, solve_mode="pcg", max_iterations=2)
    cached = TB.bundle_adjust(split, pcg_max_rows=2, **kw)
    assert float(cached["cost_final"]) == float(plain["cost_final"])
    _, flipped = flipped_problems(8, 300, 4, row_width=2)
    with pytest.raises(ValueError, match="requires sorted point_rows"):
        TB.bundle_adjust(flipped, **kw)
