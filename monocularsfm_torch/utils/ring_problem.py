"""The repo bench's camera-ring bundle-adjustment problem, built with the port.

The same recipe as bench.py's `_ring_problem` (which imports the JAX
package): a ring of cameras around a point cloud, 0.5 px observation noise,
up to `track` observing cameras per point drawn at random, cameras and
points perturbed from the truth, camera 0 pinned.  The smoke, the scaling
table and the parallel dry run build their problems here.
"""

from __future__ import annotations

import numpy as np
import torch


def ring_problem(cams: int, points: int, track: int, seed: int = 2,
                 row_width: int | None = None):
    """(BundleProblem on the CPU, number of valid observations).  With
    `row_width` every track is split into rows of that width (sorted
    point_rows, the PCG solver's cached path)."""
    from monocularsfm_torch.geometry import angle_axis_to_matrix
    from monocularsfm_torch.optim import make_bundle_problem
    from monocularsfm_torch.utils.synthetic import camera_ring_scene

    scene = camera_ring_scene(num_cameras=cams, num_points=points,
                              noise_px=0.5, seed=seed)
    rng = np.random.default_rng(0)
    # Up to `track` observing cameras per point: random keys, invisible
    # cameras pushed past every visible one, the smallest keys taken.
    vis = scene.visible.T
    keys = rng.random(vis.shape) + np.where(vis, 0.0, 10.0)
    order = np.argpartition(keys, min(track, vis.shape[1] - 1), axis=1)
    obs_cam = order[:, :track].astype(np.int32)
    obs_valid = np.take_along_axis(vis, order[:, :track], axis=1)
    obs_uv = scene.observations[obs_cam, np.arange(points)[:, None]].astype(np.float32)
    aa = torch.from_numpy(rng.normal(scale=0.01, size=(cams, 3))).float()
    R = np.einsum("cij,cjk->cik", angle_axis_to_matrix(aa).double().numpy(),
                  scene.R)
    t = scene.t + rng.normal(scale=0.02, size=(cams, 3))
    X = scene.points + rng.normal(scale=0.02, size=scene.points.shape)
    K4 = [scene.K[0, 0], scene.K[1, 1], scene.K[0, 2], scene.K[1, 2]]
    const = np.arange(cams) == 0
    nobs = int(obs_valid.sum())
    if row_width is None:
        return make_bundle_problem(K4, R, t, X, obs_cam, obs_uv, obs_valid,
                                   const), nobs
    nrow = -(-track // row_width)
    return make_bundle_problem(
        K4, R, t, X, obs_cam.reshape(-1, row_width),
        obs_uv.reshape(-1, row_width, 2), obs_valid.reshape(-1, row_width),
        const, point_valid=obs_valid.any(1),
        point_rows=np.repeat(np.arange(points), nrow)), nobs
