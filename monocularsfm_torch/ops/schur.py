"""The Schur complement's product of the PCG path: a kernel and its plain version.

Bundle adjustment's PCG (optim/ba.py) multiplies the reduced camera system

    S x = U_d x - sum_p W_p Vi_p W_p^T x

by a camera vector x at every CG step, from the coupling blocks W (O, 6, 3)
cached once per LM iteration, the points' damped inverses Vi (P, 3, 3) and
the cameras' damped blocks U_d (C, 6, 6).  On a CUDA tensor
`schur_product` launches csrc/schur.cu (a point-major pass that reads each
W block once, then a camera pass over the per-observation payload it
wrote) or raises; on a CPU tensor it runs `schur_product_plain`, the
composition of `points_of`, Vi and `cams_of` that the solver also uses
for its right-hand side and its step.  The kernel replaces no Pallas
kernel: the JAX package leaves this product to XLA.

`schur_plan` builds, once per solve, what both need from the camera and
point sum plans (utils/segment.py): the plain version sums through them;
the kernel takes the observations in point order (the point plan's
order, or as they come when they come sorted) with each one's camera,
point and row of the camera order (the inverse of the camera plan's
order), and each camera's first row there.  The kernel's sums run in an
order fixed by those plans (no float atomics), so one input gives one
result bit for bit; it differs from the plain version by float32
rounding, as the planned sums do from `index_add_`.
"""

from __future__ import annotations

import dataclasses

import torch

from monocularsfm_torch.ops import _build
from monocularsfm_torch.utils.segment import SegmentPlan, segment_sum

# The passes that did a product's work, one of each a product: counted by
# the wrapper where it launches them without a flag, and by the caller
# (`count_passes`) where a flag gates them (see `schur_product`).
LAUNCHES = {"schur_points": 0, "schur_cams": 0}
# The point pass's tile: a block of it owns the points that start in TILE
# consecutive positions of the point order (csrc/schur.cu's kTile).
TILE = 128


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count_passes(plan: "SchurPlan", products: int) -> None:
    """Add `products` to the count of each pass that has work under `plan`
    (the point pass where there are observations, the camera pass where
    there are cameras)."""
    if plan.cam_plan.ids.numel():
        LAUNCHES["schur_points"] += products
    if plan.cam_plan.num_segments:
        LAUNCHES["schur_cams"] += products


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (..., m, n) x (..., n) -> (..., m) as a
    broadcast product and a sum (cuBLAS's batched gemv runs millions of
    these tiny blocks at a small fraction of memory bandwidth)."""
    return (M * v[..., None, :]).sum(-1)


@dataclasses.dataclass(frozen=True)
class SchurPlan:
    cam_plan: SegmentPlan      # sums over the observations' cameras
    pt_plan: SegmentPlan       # sums over the observations' points
    # The kernel's layout, for plans with a fixed order (None on the CPU).
    # Per position of the point order, int32: the observation there (None
    # where they come in point order), its point, its camera and its row
    # of the camera order.
    order: torch.Tensor | None = None
    pt: torch.Tensor | None = None
    cam: torch.Tensor | None = None
    slot: torch.Tensor | None = None
    # (tiles + 1,) int32: the first position of each tile's points, the
    # first point start at or after its TILE positions (n where none).
    tile_start: torch.Tensor | None = None
    cam_start: torch.Tensor | None = None  # (C + 1,) int32 first rows


def camera_slots(cam_plan: SegmentPlan) -> torch.Tensor:
    """(O,) int32: each observation's row in the camera order, the inverse
    of `cam_plan.order` (the identity where the ids come sorted)."""
    n = cam_plan.ids.numel()
    pos = torch.arange(n, dtype=torch.int32, device=cam_plan.ids.device)
    if cam_plan.order is None:
        return pos
    return torch.empty_like(pos).index_put_((cam_plan.order,), pos)


def schur_plan(cam_plan: SegmentPlan, pt_plan: SegmentPlan) -> SchurPlan:
    """The product's plan over the observations of `cam_plan` and `pt_plan`
    (the same observations in the same order): the kernel's layout where
    the plans have a fixed order (every plan on the card), else the plans
    alone.  No host read."""
    if not (cam_plan.levels and pt_plan.levels):
        return SchurPlan(cam_plan, pt_plan)
    n = cam_plan.ids.numel()
    if pt_plan.ids.numel() != n:
        raise ValueError(f"{n} camera ids for {pt_plan.ids.numel()} point ids")
    if n > 1 << 30:
        raise ValueError(f"{n} observations: the kernel takes at most 2**30")
    i32 = torch.int32
    slot = camera_slots(cam_plan)
    cam, pt, order = cam_plan.ids, pt_plan.ids, pt_plan.order
    if order is not None:
        slot, cam, pt = slot[order], cam[order], pt[order]
        order = order.to(i32)
    sorted_cams = (cam_plan.ids if cam_plan.order is None
                   else cam_plan.ids[cam_plan.order])
    cam_start = torch.searchsorted(
        sorted_cams, torch.arange(cam_plan.num_segments + 1,
                                  device=sorted_cams.device,
                                  dtype=sorted_cams.dtype))
    return SchurPlan(cam_plan, pt_plan, order, pt.to(i32), cam.to(i32), slot,
                     tile_starts(pt), cam_start.to(i32))


def tile_starts(pt: torch.Tensor) -> torch.Tensor:
    """(ceil(n / TILE) + 1,) int32 for the non-decreasing point ids `pt`
    (n,): for each tile of TILE positions, the first position at or after
    its start where a point starts (n where none does), then n."""
    n = pt.numel()
    if n == 0:
        return torch.zeros(1, dtype=torch.int32, device=pt.device)
    # Past the point at a tile's last position lies the next tile's start.
    mid = torch.searchsorted(pt, pt[TILE - 1:n - 1:TILE].contiguous(), right=True)
    return torch.cat([mid.new_zeros(1), mid, mid.new_tensor([n])]).to(torch.int32)


def points_of(W: torch.Tensor, x: torch.Tensor, plan: SchurPlan) -> torch.Tensor:
    """(C, 6) -> (P, 3): each point's sum of W_o^T x_cam over its
    observations."""
    return segment_sum(_mv(W.transpose(-1, -2), x[plan.cam_plan.ids]),
                       plan.pt_plan)


def cams_of(W: torch.Tensor, y: torch.Tensor, plan: SchurPlan) -> torch.Tensor:
    """(P, 3) -> (C, 6): each camera's sum of W_o y_pt over its
    observations."""
    return segment_sum(_mv(W, y[plan.pt_plan.ids]), plan.cam_plan)


def schur_product_plain(W, Vi, x, plan: SchurPlan, U_d=None) -> torch.Tensor:
    """U_d x - sum_p W_p Vi_p W_p^T x, or the sum alone where U_d is None."""
    s = cams_of(W, _mv(Vi, points_of(W, x, plan)), plan)
    return s if U_d is None else _mv(U_d, x) - s


def _check(name: str, t: torch.Tensor, shape: tuple, dtype, dev) -> None:
    if t.device != dev:
        raise ValueError(f"schur_product: {name} lies on {t.device}, not {dev}")
    if t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"schur_product: {name} must be {dtype} {shape}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"schur_product: {name} must be contiguous and "
                         f"16-byte aligned")


def schur_product(W: torch.Tensor, Vi: torch.Tensor, x: torch.Tensor,
                  plan: SchurPlan, U_d: torch.Tensor | None = None, *,
                  active: torch.Tensor | None = None,
                  out: torch.Tensor | None = None,
                  payload: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel (CUDA tensors) or `schur_product_plain` (CPU tensors):
    W (O, 6, 3), Vi (P, 3, 3), x (C, 6), U_d (C, 6, 6) or None, all
    float32, over the plan's O observations, P points and C cameras.

    On the card, `out` (C, 6) and `payload` (O, 8) float32 may be given to
    write into (else each call allocates them), and `active`, an int32
    device scalar, gates both passes: where it reads 0 when they run they
    leave `out` as it was.  A gated launch may be one node of a CUDA graph,
    replayed any number of times and past the gate, so this wrapper counts
    it in `LAUNCHES` only without a gate; a caller that gates counts with
    `count_passes` the products that ran with the gate open."""
    if x.device.type == "cpu":
        return schur_product_plain(W, Vi, x, plan, U_d)
    if plan.cam is None:
        raise ValueError("schur_product on the card needs a plan built from "
                         "fixed-order plans (segment_plan on the card)")
    n, C = plan.cam.numel(), plan.cam_plan.num_segments
    dev, f32 = x.device, torch.float32
    _check("x", x, (C, 6), f32, dev)
    _check("W", W, (n, 6, 3), f32, dev)
    _check("Vi", Vi, (plan.pt_plan.num_segments, 3, 3), f32, dev)
    if U_d is not None:
        _check("U_d", U_d, (C, 6, 6), f32, dev)
    if active is not None and (active.device != dev or active.numel() != 1
                               or active.dtype != torch.int32):
        raise ValueError("schur_product: active must be one int32 on the "
                         f"card, got {active.dtype} {tuple(active.shape)} "
                         f"on {active.device}")
    if plan.cam.device != dev:
        raise ValueError(f"schur_product: the plan lies on {plan.cam.device}, "
                         f"not {dev}")
    # The kernel's scratch: 8 floats an observation (csrc/schur.cu's kRow).
    if payload is None:
        payload = torch.empty((n, 8), dtype=f32, device=dev)
    _check("payload", payload, (n, 8), f32, dev)
    if out is None:
        out = torch.empty((C, 6), dtype=f32, device=dev)
    _check("out", out, (C, 6), f32, dev)
    _build.check(_build.lib().sfm_schur_product(
        W.data_ptr(), None if plan.order is None else plan.order.data_ptr(),
        plan.pt.data_ptr(), plan.cam.data_ptr(), plan.slot.data_ptr(),
        Vi.data_ptr(), x.data_ptr(), plan.tile_start.data_ptr(),
        plan.cam_start.data_ptr(), None if U_d is None else U_d.data_ptr(),
        None if active is None else active.data_ptr(),
        payload.data_ptr(), out.data_ptr(), n, TILE,
        plan.tile_start.numel() - 1, C, _build.stream_ptr(dev)),
        "sfm_schur_product")
    if active is None:
        count_passes(plan, 1)
    return out
