"""The Schur complement's product (ops/schur.py) on the CPU: its plain
version against the solver's composition it replaced, and the kernel's
layout (the camera-order rows, the point order) on small hand-built plans.
The kernel itself runs on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from monocularsfm_torch.ops import schur
from monocularsfm_torch.ops.schur import (
    camera_slots,
    schur_plan,
    schur_product,
    schur_product_plain,
    tile_starts,
)
from monocularsfm_torch.utils.segment import fixed_order_plan, segment_plan, segment_sum


def _inputs(layout, seed=0, C=9, P=120, n=700):
    """Ids of n observations of P points in C cameras (the last camera has
    none, as have some points) and float32 blocks: "sorted" ids as one row
    a point gives them, "split" sorted with a quarter of the points in
    runs of about 23 (tracks split over rows), "unsorted" shuffled."""
    rng = np.random.default_rng(seed)
    pt = np.sort(rng.integers(0, P // 4 if layout == "split" else P, n))
    if layout == "unsorted":
        pt = rng.permutation(pt)
    cam = rng.integers(0, C - 1, len(pt))
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    return (torch.from_numpy(cam), torch.from_numpy(pt), f(len(pt), 6, 3),
            f(P, 3, 3), f(C, 6), f(C, 6, 6), C, P)


def _mv(M, v):
    return (M * v[..., None, :]).sum(-1)


@pytest.mark.parametrize("layout", ["sorted", "split", "unsorted"])
@pytest.mark.parametrize("with_u", [True, False])
def test_plain_product_equals_the_solvers_composition(layout, with_u):
    """Bit for bit the product optim/ba.py composed before the kernel:
    `_mv(U_d, x) - Wy_cams(_mv(Vi, WT_pts(x)))`, each sum `segment_sum`
    (`index_add_` on the CPU); without U_d the sum alone (a process
    group's product, which the caller reduces)."""
    cam, pt, W, Vi, x, U, C, P = _inputs(layout)
    cam_plan, pt_plan = segment_plan(cam, C), segment_plan(pt, P)
    wt = segment_sum(_mv(W.transpose(-1, -2), x[cam]), pt_plan)
    old = segment_sum(_mv(W, _mv(Vi, wt)[pt]), cam_plan)
    if with_u:
        old = _mv(U, x) - old
    plan = schur_plan(cam_plan, pt_plan)
    assert plan.cam is None                       # the CPU keeps the plans alone
    out = schur_product(W, Vi, x, plan, U if with_u else None)
    assert torch.equal(out, old)
    assert torch.equal(out, schur_product_plain(W, Vi, x, plan, U if with_u else None))
    W64, x64 = W.double().numpy(), x.double().numpy()
    z = np.zeros((P, 3))
    np.add.at(z, pt.numpy(), np.einsum("oij,oi->oj", W64, x64[cam]))
    y = np.einsum("pij,pj->pi", Vi.double().numpy(), z)
    ref = np.zeros((C, 6))
    np.add.at(ref, cam.numpy(), np.einsum("oij,oj->oi", W64, y[pt]))
    if with_u:
        ref = np.einsum("cij,cj->ci", U.double().numpy(), x64) - ref
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-3)


@pytest.mark.parametrize("ids,slots,start", [
    ([0, 0, 1, 2, 2, 2], [0, 1, 2, 3, 4, 5], [0, 2, 3, 6, 6]),  # sorted: identity
    ([2, 0, 1, 0, 2], [3, 0, 2, 1, 4], [0, 2, 3, 5, 5]),
    ([3, 3, 0], [1, 2, 0], [0, 1, 1, 1, 3]),                    # empty cameras
    ([], [], [0, 0, 0, 0, 0]),
])
def test_camera_rows_invert_the_camera_order(ids, slots, start):
    """Each observation's row of the camera order is the inverse of the
    camera plan's stable order (the identity where the ids come sorted),
    and each camera's rows start where the sorted ids say, for 4 cameras."""
    cam = torch.tensor(ids, dtype=torch.int64)
    cam_plan = fixed_order_plan(cam, 4)
    got = camera_slots(cam_plan)
    assert got.dtype == torch.int32 and got.tolist() == slots
    if cam_plan.order is not None:
        assert torch.equal(got[cam_plan.order].long(), torch.arange(len(ids)))
    plan = schur_plan(cam_plan, fixed_order_plan(torch.zeros_like(cam), 1))
    assert plan.cam_start.dtype == torch.int32 and plan.cam_start.tolist() == start


def test_point_order_layout_on_a_hand_built_plan():
    """Unsorted point ids: the positions walk the observations in the point
    plan's stable order, and carry each one's point, camera and row of the
    camera order; sorted ids keep the observations' own order."""
    cam = torch.tensor([2, 0, 1, 0, 2])
    pt = torch.tensor([1, 0, 1, 2, 0])
    plan = schur_plan(fixed_order_plan(cam, 3), fixed_order_plan(pt, 3))
    assert plan.order.tolist() == [1, 4, 0, 2, 3]
    assert plan.pt.tolist() == [0, 0, 1, 1, 2]
    assert plan.cam.tolist() == [0, 2, 2, 1, 0]
    assert plan.slot.tolist() == [0, 4, 3, 2, 1]
    assert all(t.dtype == torch.int32 for t in (plan.order, plan.pt, plan.cam, plan.slot))
    plan = schur_plan(fixed_order_plan(cam, 3), fixed_order_plan(torch.sort(pt)[0], 3))
    assert plan.order is None
    assert plan.cam.tolist() == cam.tolist() and plan.slot.tolist() == [3, 0, 2, 1, 4]


@pytest.mark.parametrize("layout", ["sorted", "unsorted"])
def test_kernel_layout_covers_each_row_once(layout):
    """On random plans: the rows form a permutation of the observations,
    the row of an observation lies inside its camera's range, and the
    positions' points never decrease (the kernel walks points in runs)."""
    cam, pt, *_, C, P = _inputs(layout, seed=3)
    plan = schur_plan(fixed_order_plan(cam, C), fixed_order_plan(pt, P))
    slot, c = plan.slot.long(), plan.cam.long()
    assert torch.equal(torch.sort(slot)[0], torch.arange(len(cam)))
    start = plan.cam_start.long()
    assert ((start[c] <= slot) & (slot < start[c + 1])).all()
    assert (plan.pt.diff() >= 0).all()
    obs = torch.arange(len(cam)) if plan.order is None else plan.order.long()
    assert torch.equal(cam[obs], c) and torch.equal(pt[obs], plan.pt.long())


@pytest.mark.parametrize("pt,starts", [
    ([0, 0, 0, 1, 1, 1, 1, 1, 1, 2, 3, 3], [0, 9, 9, 12]),   # a point across a tile
    ([0, 1, 2, 3, 4, 5, 6, 7], [0, 4, 8]),                   # one position a point
    ([5] * 10, [0, 10, 10, 10]),                            # one point, three tiles
    ([0, 1, 1, 1, 1], [0, 5, 5]),
    ([], [0]),
])
def test_tiles_start_where_points_start(monkeypatch, pt, starts):
    """Tiles of 4 positions: each begins at the first point start at or
    after its first position, so a block owns whole points; a tile inside
    a point owns none (its start is the next tile's)."""
    monkeypatch.setattr(schur, "TILE", 4)
    got = tile_starts(torch.tensor(pt, dtype=torch.int64))
    assert got.dtype == torch.int32 and got.tolist() == starts
