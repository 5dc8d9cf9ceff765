"""The port's geometry, sliced linear algebra and E/H/EPnP/P3P estimators against
the JAX package's, on the CPU, with the reference's RANSAC draws injected."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocularsfm_torch import geometry as TG
from monocularsfm_torch.estimators import essential as TE
from monocularsfm_torch.estimators import homography as TH
from monocularsfm_torch.estimators import pnp as TP
from monocularsfm_torch.utils import linalg
from monocularsfm_tpu import geometry as JG
from monocularsfm_tpu.estimators import essential as JE
from monocularsfm_tpu.estimators import homography as JH
from monocularsfm_tpu.estimators import pnp as JP
from monocularsfm_tpu.geometry.rotations import angle_axis_rotate_point as j_rotate
from monocularsfm_torch.geometry.rotations import angle_axis_rotate_point as t_rotate

GEOM_TOL = 1e-5
POSE_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return np.asarray(a)


def _draws(key, m, n):
    """The uniform draws a reference estimator makes inside from `key`."""
    return _t(jax.random.uniform(key, (m, n)))


def _K():
    return np.array([[500.0, 0, 320], [0, 510.0, 240], [0, 0, 1]], np.float32)


def test_sliced_eigh_equals_one_unsliced_call():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((40000, 4, 4))
    spd = torch.from_numpy(A @ A.transpose(0, 2, 1) + 0.1 * np.eye(4))
    assert spd.shape[0] > 2 * linalg.BATCH
    w, V = linalg.eigh(spd)
    w_ref, V_ref = torch.linalg.eigh(spd)
    assert (w - w_ref).abs().max().item() <= 1e-6
    sign = torch.sign((V * V_ref).sum(-2, keepdim=True))   # up to sign per vector
    assert (V * sign - V_ref).abs().max().item() <= 1e-6
    U, S, Vh = linalg.svd(spd[:, :3, :])
    S_ref = torch.linalg.svdvals(spd[:, :3, :])
    assert U.shape == (40000, 3, 3) and Vh.shape == (40000, 3, 4)
    assert (S - S_ref).abs().max().item() <= 1e-6


@pytest.mark.parametrize("scale", [1e-5, 0.3, 3.0])
def test_rotations_match_reference(scale):
    rng = np.random.default_rng(1)
    aa = (rng.standard_normal((64, 3)) * scale).astype(np.float32)
    pts = rng.standard_normal((64, 3)).astype(np.float32)
    R_j = _j(JG.angle_axis_to_matrix(jnp.asarray(aa)))
    R_t = TG.angle_axis_to_matrix(_t(aa)).numpy()
    np.testing.assert_allclose(R_t, R_j, atol=GEOM_TOL)
    np.testing.assert_allclose(TG.matrix_to_angle_axis(_t(R_j)).numpy(),
                               _j(JG.matrix_to_angle_axis(jnp.asarray(R_j))),
                               atol=GEOM_TOL)
    q_j = _j(JG.matrix_to_quaternion(jnp.asarray(R_j)))
    np.testing.assert_allclose(TG.matrix_to_quaternion(_t(R_j)).numpy(), q_j,
                               atol=GEOM_TOL)
    np.testing.assert_allclose(TG.quaternion_to_matrix(_t(q_j)).numpy(),
                               _j(JG.quaternion_to_matrix(jnp.asarray(q_j))),
                               atol=GEOM_TOL)
    np.testing.assert_allclose(t_rotate(_t(aa), _t(pts)).numpy(),
                               _j(j_rotate(jnp.asarray(aa), jnp.asarray(pts))),
                               atol=GEOM_TOL)


def test_projection_matches_reference():
    rng = np.random.default_rng(2)
    K = _K()
    R = _j(JG.angle_axis_to_matrix(jnp.asarray(
        rng.standard_normal((16, 3)).astype(np.float32) * 0.2)))
    t = (rng.standard_normal((16, 3)) * 0.5 + [0, 0, 5]).astype(np.float32)
    X = rng.standard_normal((16, 3)).astype(np.float32)
    uv = rng.uniform(0, 600, (16, 2)).astype(np.float32)
    pairs = [
        (JG.project(K, R, t, X), TG.project(_t(K), _t(R), _t(t), _t(X))),
        (JG.calculate_reprojection_error(K, R, t, X, uv),
         TG.calculate_reprojection_error(_t(K), _t(R), _t(t), _t(X), _t(uv))),
        (JG.camera_center(R, t), TG.camera_center(_t(R), _t(t))),
        (JG.has_positive_depth(R, t, X), TG.has_positive_depth(_t(R), _t(t), _t(X))),
        (JG.calculate_parallax_angle_deg(t, X, X * 2.0 + 1.0),
         TG.calculate_parallax_angle_deg(_t(t), _t(X), _t(X * 2.0 + 1.0))),
    ]
    for a, b in pairs:
        a = _j(a)
        np.testing.assert_allclose(b.numpy(), a, atol=GEOM_TOL,
                                   rtol=GEOM_TOL)


def test_undistort_matches_reference():
    from monocularsfm_torch.ops import undistort as TU
    from monocularsfm_tpu.ops import undistort as JU

    rng = np.random.default_rng(8)
    K = _K()
    dist = np.array([-0.12, 0.03, 1e-3, -5e-4], np.float32)
    uv = rng.uniform([0, 0], [640, 480], (500, 2)).astype(np.float32)
    out = TU.undistort_pixels(uv, K, dist).numpy()
    # Pixels up to 640 in f32: compare to 1e-5 relative, 1e-4 px absolute.
    np.testing.assert_allclose(out, _j(JU.undistort_pixels(uv, K, dist)),
                               rtol=GEOM_TOL, atol=1e-4)
    # The inverse holds: distorting the undistorted points gives them back.
    xn = (out - K[:2, 2]) / K[[0, 1], [0, 1]]
    back = TU.distort(_t(xn), _t(dist)).numpy() * K[[0, 1], [0, 1]] + K[:2, 2]
    np.testing.assert_allclose(back, uv, atol=1e-2)


def _look_at_origin(C):
    """World->camera (R, t) of a camera at C looking at the origin."""
    z = -C / np.linalg.norm(C)
    x = np.cross([0.0, 1.0, 0.0], z)
    x /= np.linalg.norm(x)
    R = np.stack([x, np.cross(z, x), z])
    return R, -R @ C


def test_triangulation_matches_reference():
    # Five cameras on a 60-degree arc at distance 4 around a unit cube of
    # points: every point is in front of every camera with wide parallax,
    # so the f32 eigensolvers of both packages agree within the tolerance.
    rng = np.random.default_rng(3)
    V, N = 5, 200
    ang = np.radians(np.linspace(-30.0, 30.0, V))
    C = np.stack([4 * np.sin(ang), 0.3 * rng.standard_normal(V), -4 * np.cos(ang)], 1)
    R, t = (np.stack(a).astype(np.float32) for a in zip(*map(_look_at_origin, C)))
    X = rng.uniform(-0.5, 0.5, (N, 3)).astype(np.float32)
    xc = np.einsum("vij,nj->nvi", R, X) + t
    xn = (xc[..., :2] / xc[..., 2:]).astype(np.float32)
    xn += rng.normal(scale=1e-3, size=xn.shape).astype(np.float32)
    mask = rng.random((N, V)) < 0.8
    mask[:, [0, -1]] = True
    Rb = np.broadcast_to(R, (N, V, 3, 3))
    tb = np.broadcast_to(t, (N, V, 3))
    Xj = _j(JG.triangulate_n_view(Rb, tb, xn, mask))
    Xt = TG.triangulate_n_view(_t(Rb.copy()), _t(tb.copy()), _t(xn), _t(mask)).numpy()
    np.testing.assert_allclose(Xt, Xj, atol=GEOM_TOL, rtol=GEOM_TOL)
    assert np.median(np.abs(Xt - X)) < 0.01           # and near the truth
    X2j = _j(JG.triangulate_two_view(R[0], t[0], R[-1], t[-1], xn[:, 0], xn[:, -1]))
    X2t = TG.triangulate_two_view(_t(R[0]), _t(t[0]), _t(R[-1]), _t(t[-1]),
                                  _t(xn[:, 0].copy()), _t(xn[:, -1].copy())).numpy()
    np.testing.assert_allclose(X2t, X2j, atol=GEOM_TOL, rtol=GEOM_TOL)
    assert np.median(np.abs(X2t - X)) < 0.01


def _two_views(planar, n=300, cap=512, outliers=0.2, seed=4):
    rng = np.random.default_rng(seed)
    K = _K().astype(np.float64)
    if planar:
        X = np.c_[rng.uniform(-2, 2, (n, 2)), np.full(n, 6.0)]
    else:
        X = np.c_[rng.uniform(-2, 2, (n, 2)), rng.uniform(4, 8, n)]
    R2 = np.asarray(JG.angle_axis_to_matrix(jnp.asarray([0.02, -0.15, 0.03])),
                    np.float64)
    t2 = np.array([1.0, 0.05, 0.1])
    uv1 = (X / X[:, 2:]) @ K.T
    x2 = X @ R2.T + t2
    uv2 = (x2 / x2[:, 2:]) @ K.T
    uv1 = uv1[:, :2] + rng.normal(scale=0.3, size=(n, 2))
    uv2 = uv2[:, :2] + rng.normal(scale=0.3, size=(n, 2))
    bad = rng.random(n) < outliers
    uv2[bad] = rng.uniform(0, 640, (bad.sum(), 2))
    x1p = np.zeros((cap, 2), np.float32)
    x2p = np.zeros((cap, 2), np.float32)
    m = np.zeros(cap, bool)
    x1p[:n], x2p[:n], m[:n] = uv1, uv2, True
    return K.astype(np.float32), x1p, x2p, m


def test_essential_and_pose_match_reference():
    K, x1, x2, m = _two_views(planar=False)
    xn1 = _j(JE.pixels_to_normalized(K, x1))
    xn2 = _j(JE.pixels_to_normalized(K, x2))
    np.testing.assert_allclose(
        TE.pixels_to_normalized(_t(K), _t(x1)).numpy(), xn1, atol=1e-6)
    key = jax.random.PRNGKey(3)
    thr = 4.0 / float(K[0, 0])
    ref = JE.estimate_essential_ransac(key, xn1, xn2, m, threshold_norm=thr,
                                       num_hyps=256)
    out = TE.estimate_essential_ransac(_draws(key, 256, len(m)), _t(xn1),
                                       _t(xn2), _t(m), threshold_norm=thr)
    np.testing.assert_array_equal(out["inliers"].numpy(), _j(ref["inliers"]))
    Ej, Et = _j(ref["E"]), out["E"].numpy()
    Ej, Et = Ej / np.linalg.norm(Ej), Et / np.linalg.norm(Et)
    assert min(np.abs(Ej - Et).max(), np.abs(Ej + Et).max()) <= POSE_TOL
    Rj, tj, Xj, fj = JE.recover_pose_from_essential(ref["E"], xn1, xn2, ref["inliers"])
    Rt, tt, Xt, ft = TE.recover_pose_from_essential(out["E"], _t(xn1), _t(xn2),
                                                    out["inliers"])
    np.testing.assert_allclose(Rt.numpy(), _j(Rj), atol=POSE_TOL)
    np.testing.assert_allclose(tt.numpy(), _j(tj), atol=POSE_TOL)
    np.testing.assert_array_equal(ft.numpy(), _j(fj))


def test_homography_and_decomposition_match_reference():
    K, x1, x2, m = _two_views(planar=True)
    key = jax.random.PRNGKey(5)
    ref = JH.estimate_homography_ransac(key, x1, x2, m, threshold_px=12.0,
                                        num_hyps=256)
    out = TH.estimate_homography_ransac(_draws(key, 256, len(m)), _t(x1),
                                        _t(x2), _t(m), threshold_px=12.0)
    np.testing.assert_array_equal(out["inliers"].numpy(), _j(ref["inliers"]))
    Hj, Ht = _j(ref["H"]), out["H"].numpy()       # both scaled to H[2,2] = 1
    assert np.abs(Hj - Ht).max() / np.abs(Hj).max() <= POSE_TOL
    # Candidate order may differ with the SVD signs: compare the motion the
    # cheirality test picks, as the initializer does.
    from monocularsfm_torch.reconstruction.initializer import _homography_motion as t_hm
    from monocularsfm_tpu.reconstruction.initializer import _homography_motion as j_hm

    jo = j_hm(jnp.asarray(K), ref["H"], x1, x2, ref["inliers"])
    to = t_hm(_t(K), out["H"], _t(x1), _t(x2), out["inliers"])
    bj, bt = int(np.argmax(_j(jo[6]))), int(np.argmax(to[6].numpy()))
    np.testing.assert_allclose(to[2][bt].numpy(), _j(jo[2][bj]), atol=POSE_TOL)
    tj = _j(jo[3][bj])
    tt = to[3][bt].numpy()
    np.testing.assert_allclose(tt / np.linalg.norm(tt), tj / np.linalg.norm(tj),
                               atol=POSE_TOL)
    np.testing.assert_array_equal(to[5][bt].numpy(), _j(jo[5][bj]))


def test_symmetric_transfer_error_matches_reference():
    rng = np.random.default_rng(9)
    H = np.eye(3) + rng.normal(scale=[[0.05, 0.05, 8.0], [0.05, 0.05, 8.0],
                                      [1e-4, 1e-4, 0.01]], size=(4, 3, 3))
    H = H.astype(np.float32)
    Hinv = np.linalg.inv(H).astype(np.float32)
    x1 = rng.uniform(0, 640, size=(4, 50, 2)).astype(np.float32)
    x2 = x1 + rng.normal(scale=3.0, size=x1.shape).astype(np.float32)
    ref = _j(JH.symmetric_transfer_error(*map(jnp.asarray, (H, Hinv, x1, x2))))
    out = TH.symmetric_transfer_error(*map(_t, (H, Hinv, x1, x2))).numpy()
    assert out.shape == ref.shape == (4, 50) and ref.min() > 0
    np.testing.assert_allclose(out, ref, rtol=1e-5)


def test_epnp_ransac_matches_reference():
    rng = np.random.default_rng(6)
    n, cap, M = 300, 512, 256
    K = _K()
    X = np.c_[rng.uniform(-2, 2, (n, 2)), rng.uniform(4, 8, n)].astype(np.float32)
    R = np.asarray(JG.angle_axis_to_matrix(jnp.asarray([0.05, 0.2, -0.04])))
    t = np.array([0.3, -0.1, 0.5], np.float32)
    xc = X @ R.T + t
    uv = (xc / xc[:, 2:]) @ K.T
    uv = uv[:, :2] + rng.normal(scale=0.5, size=(n, 2))
    bad = rng.random(n) < 0.3
    uv[bad] = rng.uniform(0, 640, (bad.sum(), 2))
    Xp = np.zeros((cap, 3), np.float32)
    Up = np.zeros((cap, 2), np.float32)
    m = np.zeros(cap, bool)
    Xp[:n], Up[:n], m[:n] = X, uv, True
    key = jax.random.PRNGKey(7)
    ref = JP.estimate_pnp_ransac(key, K, Xp, Up, m, threshold_px=4.0,
                                 num_hyps=M, method="epnp")
    out = TP.estimate_pnp_ransac(_draws(key, M, cap), _t(K), _t(Xp), _t(Up),
                                 _t(m), threshold_px=4.0)
    np.testing.assert_array_equal(out["inliers"].numpy(), _j(ref["inliers"]))
    np.testing.assert_allclose(out["R"].numpy(), _j(ref["R"]), atol=POSE_TOL)
    np.testing.assert_allclose(out["t"].numpy(), _j(ref["t"]), atol=POSE_TOL)
    assert abs(float(out["mean_inlier_error_px"])
               - float(ref["mean_inlier_error_px"])) <= 1e-3
    np.testing.assert_allclose(out["R"].numpy(), R, atol=0.01)
    # The same inputs through P3P (tests/test_torch_pnp.py holds every method).
    ref = JP.estimate_pnp_ransac(key, K, Xp, Up, m, threshold_px=4.0,
                                 num_hyps=M, method="p3p")
    out = TP.estimate_pnp_ransac(_draws(key, M, cap), _t(K), _t(Xp), _t(Up),
                                 _t(m), threshold_px=4.0, method="p3p")
    np.testing.assert_array_equal(out["inliers"].numpy(), _j(ref["inliers"]))
    np.testing.assert_allclose(out["R"].numpy(), _j(ref["R"]), atol=POSE_TOL)
    np.testing.assert_allclose(out["t"].numpy(), _j(ref["t"]), atol=POSE_TOL)
