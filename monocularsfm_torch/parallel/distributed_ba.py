"""Landmark-sharded distributed bundle adjustment.

The port of monocularsfm_tpu/parallel/distributed_ba.py.  Each rank owns a
contiguous slab of the points and their observations; the cameras are
replicated.  Every LM iteration each rank builds its residuals, Jacobian
blocks and point blocks, and its part of the reduced camera system; the
camera-side sums are all-reduced over the mesh's group, the camera solve
runs identically on every rank, and the point back-substitution stays
local (optim/ba.py with `group`).

As in the reference, `dispatch_iters` runs the optimisation in segments
that carry the solver state, each rank's slab of X included, from one to
the next; every rank decides whether to go on from the same reduced
iteration count and convergence flag, so the ranks stay in step.  Across
processes JAX leaves X sharded; here X is gathered on every rank, because
the controller's map needs it.
"""

from __future__ import annotations

import dataclasses

import torch

from monocularsfm_torch.optim.ba import BundleProblem, bundle_adjust
from monocularsfm_torch.parallel.mesh import all_gather, mesh_device

_POINT_FIELDS = ("X", "point_valid", "obs_cam", "obs_uv", "obs_valid")


def _pad_points(prob: BundleProblem, multiple: int) -> BundleProblem:
    """Pad the point axis to a multiple of `multiple` with invalid points."""
    n = prob.X.shape[0]
    pad = -n % multiple
    if pad == 0:
        return prob
    return dataclasses.replace(prob, **{
        f: torch.cat([getattr(prob, f), getattr(prob, f).new_zeros(
            (pad,) + tuple(getattr(prob, f).shape[1:]))])
        for f in _POINT_FIELDS})


def distributed_bundle_adjust(prob: BundleProblem, mesh,
                              max_iterations: int = 50,
                              solve_mode: str = "dense",
                              dispatch_iters: int | None = None, **kwargs):
    """Run LM with the points sharded over `mesh`'s ranks, in segments of
    at most `dispatch_iters` LM iterations (None: one segment).

    SPMD: every rank calls this with the same `prob` (on any device; each
    rank moves its slab to its own).  Returns bundle_adjust's dict on every
    rank, X gathered back to the full point count."""
    if prob.point_rows is not None:
        raise ValueError("distributed BA requires the identity point_rows map")
    group = mesh.get_group()
    n = mesh.size()
    rank = mesh.get_local_rank()
    dev = mesh_device(mesh)
    n_points = prob.X.shape[0]
    prob = _pad_points(prob, n)
    s = prob.X.shape[0] // n
    local = dataclasses.replace(prob, **{
        f: getattr(prob, f)[rank * s:(rank + 1) * s] for f in _POINT_FIELDS})
    out = bundle_adjust(local.to(dev), max_iterations=max_iterations,
                        device=dev, solve_mode=solve_mode, group=group,
                        dispatch_iters=dispatch_iters, **kwargs)
    out["X"] = all_gather(out["X"], group)[:n_points]
    return out
