"""The port's landmark-sharded bundle adjustment over gloo worlds of 2 and 4
CPU ranks, against the port's unsharded solve and the JAX package's
distributed solve on a mesh of the same size (tests/test_parallel.py's
problems: the 8-camera, 400-point ring of the session fixture)."""

import numpy as np
import pytest

from monocularsfm_torch.optim import ba as TB
from monocularsfm_torch.parallel.mesh import spawn
from monocularsfm_tpu.parallel import distributed_bundle_adjust as jax_dist
from monocularsfm_tpu.parallel import make_mesh as jax_mesh
from test_bundle_adjustment import _build_problem

# Sharded against unsharded in the port: the same f32 arithmetic, summed in
# another order across ranks.
PORT_RMSE_TOL, PORT_R_TOL = 1e-4, 1e-3
# Against the JAX package's distributed solve: tests/test_parallel.py's own.
JAX_RMSE_TOL, JAX_R_TOL = 5e-3, 5e-3
PCG_TOL = 1e-2
ITERS, PCG_ITERS, PCG_INNER = 30, 20, 60
# Segmented against one segment: tests/test_parallel.py's problem and rule.
SEG_ITERS, SEG_STEP, SEG_TOL = 12, 3, 1e-3
SEGMENTED = {"dense": {}, "pcg": dict(solve_mode="pcg", pcg_iters=40)}
STEP = "monocularsfm_torch.parallel.dryrun:ba"
WORLD_TIMEOUT = 60.0


def _arrays(prob, split_rows=None):
    """A JAX BundleProblem as the port's numpy arrays; with `split_rows`
    the same observations carry an explicit row -> point map."""
    a = {f: np.asarray(getattr(prob, f)) for f in (
        "K", "R", "t", "X", "cam_valid", "cam_const", "point_valid",
        "obs_cam", "obs_uv", "obs_valid")}
    a["obs_cam"] = a["obs_cam"].astype(np.int64)
    if split_rows:
        a["point_rows"] = np.arange(len(a["X"]), dtype=np.int64)
    return a


def _port(arrays, **kw):
    prob = TB.make_bundle_problem(
        arrays["K"], arrays["R"], arrays["t"], arrays["X"], arrays["obs_cam"],
        arrays["obs_uv"], arrays["obs_valid"], arrays["cam_const"],
        cam_valid=arrays["cam_valid"], point_valid=arrays["point_valid"])
    return TB.bundle_adjust(prob, device="cpu", **kw)


@pytest.fixture(scope="module")
def problems(ring_scene):
    return {
        "dense": _build_problem(ring_scene, noise_px=0.4, perturb=0.6),
        "pcg": _build_problem(ring_scene, noise_px=0.4, perturb=0.4),
        "uneven": _build_problem(ring_scene, perturb=0.3, pnt_pad=3),
    }


@pytest.fixture(scope="module")
def worlds(problems):
    """Every rank's results: world 2 solves the dense problem, then the
    PCG problem in each solver as one segment and in segments of SEG_STEP
    LM iterations; world 4 the dense, the PCG and the 403-point problems
    and the split-row refusal."""
    dense = _arrays(problems["dense"])
    w2 = spawn(2, [(STEP, (dense, "cpu"), dict(max_iterations=ITERS))] + [
        (STEP, (_arrays(problems["pcg"]), "cpu"),
         dict(max_iterations=SEG_ITERS, dispatch_iters=step, **kw))
        for kw in SEGMENTED.values() for step in (SEG_ITERS, SEG_STEP)],
        timeout=WORLD_TIMEOUT)
    w4 = spawn(4, [
        (STEP, (dense, "cpu"), dict(max_iterations=ITERS)),
        (STEP, (_arrays(problems["pcg"]), "cpu"),
         dict(max_iterations=PCG_ITERS, solve_mode="pcg", pcg_iters=PCG_INNER)),
        (STEP, (_arrays(problems["uneven"]), "cpu"), dict(max_iterations=10)),
        (STEP, (_arrays(problems["dense"], split_rows=True), "cpu"),
         dict(max_iterations=2, solve_mode="pcg")),
    ], timeout=WORLD_TIMEOUT)
    return {2: w2, 4: w4}


@pytest.fixture(scope="module")
def port_single(problems):
    return _port(_arrays(problems["dense"]), max_iterations=ITERS)


@pytest.mark.parametrize("n", [2, 4])
def test_dense_matches_port_unsharded(worlds, port_single, n):
    dist = worlds[n][0][0]
    assert dist["X"].shape == tuple(port_single["X"].shape)
    assert abs(float(dist["rmse_final"]) - float(port_single["rmse_final"])) \
        < PORT_RMSE_TOL
    np.testing.assert_allclose(dist["R"], port_single["R"].numpy(),
                               atol=PORT_R_TOL)
    np.testing.assert_allclose(dist["X"], port_single["X"].numpy(), atol=1e-3)


@pytest.mark.parametrize("n", [2, 4])
def test_dense_matches_jax_distributed(worlds, problems, n):
    ref = jax_dist(problems["dense"], jax_mesh(n), max_iterations=ITERS)
    dist = worlds[n][0][0]
    assert abs(float(dist["rmse_final"]) - float(ref["rmse_final"])) \
        < JAX_RMSE_TOL
    np.testing.assert_allclose(dist["R"], np.asarray(ref["R"]), atol=JAX_R_TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_every_rank_holds_the_same_result(worlds, n):
    """The camera solve is replicated and X gathered: every rank returns
    the same numbers, bit for bit, after the same number of iterations."""
    first = worlds[n][0][0]
    for rank in worlds[n][1:]:
        other = rank[0]
        assert other["iterations"] == first["iterations"]
        for k in ("R", "t", "X", "cost_final"):
            np.testing.assert_array_equal(other[k], first[k])


def test_pcg_matches_port_and_jax(worlds, problems):
    dist = worlds[4][0][1]
    kw = dict(max_iterations=PCG_ITERS, solve_mode="pcg", pcg_iters=PCG_INNER)
    single = _port(_arrays(problems["pcg"]), **kw)
    ref = jax_dist(problems["pcg"], jax_mesh(4), **kw)
    for other in (float(single["rmse_final"]), float(ref["rmse_final"])):
        assert abs(float(dist["rmse_final"]) - other) < PCG_TOL


@pytest.mark.parametrize("mode", list(SEGMENTED))
def test_segmented_continuation_matches_monolithic(worlds, mode):
    """dispatch_iters under the group: the segments carry each rank's slab
    of the state, every rank stops with the others, and the result is the
    one-segment solve's (tests/test_parallel.py's rule; here they are
    equal, since the segments walk the same iterates)."""
    i = 1 + 2 * list(SEGMENTED).index(mode)
    for rank in worlds[2]:
        mono, seg = rank[i], rank[i + 1]
        assert seg["iterations"] == mono["iterations"] > SEG_STEP
        assert abs(float(seg["rmse_final"]) - float(mono["rmse_final"])) < SEG_TOL
        np.testing.assert_allclose(seg["R"], mono["R"], atol=SEG_TOL)
        np.testing.assert_array_equal(seg["X"], worlds[2][0][i + 1]["X"])


def test_point_count_not_divisible(worlds, problems):
    """403 points over 4 ranks: padded to 404, X trimmed back."""
    dist = worlds[4][0][2]
    assert np.isfinite(float(dist["rmse_final"]))
    assert dist["X"].shape == np.asarray(problems["uneven"].X).shape == (403, 3)


def test_split_rows_refused(worlds):
    assert "identity point_rows" in worlds[4][0][3]["error"]


def test_backend_rule_and_mesh_without_a_group(monkeypatch):
    """NCCL only when every local rank has a card of its own; a mesh needs
    a process group."""
    import torch

    from monocularsfm_torch.parallel import mesh

    assert mesh.choose_backend("cpu", 1) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh.choose_backend("cuda", 1) == "nccl"
    assert mesh.choose_backend("cuda", 2) == "gloo"
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_mesh(2, device="cpu")
