"""Segment sums in a fixed order: the port's `jax.ops.segment_sum`.

`index_add_` on a CUDA tensor adds with float atomics in whatever order
the threads arrive, so one input can give other bits from run to run
(torch lists it among its nondeterministic operations).  The JAX package
sums the same blocks with `jax.ops.segment_sum`, an XLA scatter-add that
sums in a fixed order.  Here the order is fixed by a plan, built once
from the ids and reused for every sum over them:

* the rows are sorted by segment (a stable argsort), unless the ids come
  sorted already;
* `torch.segment_reduce` sums each segment of at most WIDTH rows, one
  thread per segment and column adding its rows one after another;
* a longer segment is first cut into bags of max(WIDTH, ceil(sqrt(its
  longest segment's length))) consecutive rows, which a first
  `segment_reduce` sums the same way; a second one adds each segment's
  bag sums in order (one thread walking a whole long segment is slow).

The result depends only on the ids and the values, never on scheduling;
there are no atomics.

On CPU tensors `segment_sum` keeps `index_add_`: it sums each segment in
input order, as XLA's CPU scatter does, so the CPU's results against the
JAX package stay what they were, and `segment_plan` keeps only the ids
there.  On every other device it takes the planned sum.
"""

from __future__ import annotations

import dataclasses
import math

import torch

WIDTH = 32


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    ids: torch.Tensor                 # (N,) int64, the segment of each row
    num_segments: int
    # The rows sorted by segment; None where the ids are sorted already (and
    # in a plan for CPU tensors).
    order: torch.Tensor | None
    # `segment_reduce`'s offsets, one tensor per pass over the sorted rows:
    # the bags' bounds and then each segment's first bag where a segment is
    # longer than WIDTH, else each segment's first row; each ends with the
    # count of its input.  Empty in a plan for CPU tensors.
    levels: tuple[torch.Tensor, ...]


def segment_plan(ids: torch.Tensor, num_segments: int) -> SegmentPlan:
    """The plan of sums over `ids` (N,), each in [0, num_segments): only
    the ids for CPU tensors (`segment_sum` adds with `index_add_` there),
    else `fixed_order_plan`'s."""
    ids = ids.reshape(-1)
    if ids.device.type == "cpu":
        return SegmentPlan(ids, num_segments, None, ())
    return fixed_order_plan(ids, num_segments)


def fixed_order_plan(ids: torch.Tensor, num_segments: int) -> SegmentPlan:
    """The fixed-order plan of sums over `ids` (N,) on any device.  Waits
    for the device twice (once where no segment is longer than WIDTH)."""
    ids = ids.reshape(-1)
    dev, n = ids.device, ids.numel()
    order = torch.argsort(ids, stable=True)
    seg = ids[order]
    bounds = torch.searchsorted(
        seg, torch.arange(num_segments + 1, device=dev, dtype=seg.dtype))
    counts = bounds.diff()
    most, in_order = 0, True
    if n:
        most, lo, hi, in_order = torch.stack([
            counts.max(), seg[0], seg[-1], (seg == ids).all().long()]).tolist()
        if lo < 0 or hi >= num_segments:
            raise ValueError(f"segment ids span [{lo}, {hi}], outside "
                             f"[0, {num_segments})")
    order = None if in_order else order
    if most <= WIDTH:
        return SegmentPlan(ids, num_segments, order, (bounds,))
    size = max(WIDTH, math.isqrt(most - 1) + 1)
    bags = (counts + size - 1) // size
    first = torch.cumsum(bags, 0) - bags
    total = int(bags.sum())
    bag_seg = torch.repeat_interleave(torch.arange(num_segments, device=dev),
                                      bags, output_size=total)
    starts = bounds[bag_seg] + (torch.arange(total, device=dev) - first[bag_seg]) * size
    return SegmentPlan(ids, num_segments, order,
                       (torch.cat([starts, starts.new_tensor([n])]),
                        torch.cat([first, first.new_tensor([total])])))


def planned_sum(vals: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """The plan's fixed-order sum of float `vals` (N, ...) on any device."""
    shape = (plan.num_segments,) + vals.shape[1:]
    if vals.shape[0] == 0 or plan.num_segments == 0:
        return vals.new_zeros(shape)
    if not plan.levels:
        raise ValueError("a plan built for CPU tensors has no fixed order; "
                         "build it with fixed_order_plan")
    x = vals.reshape(vals.shape[0], -1)
    if plan.order is not None:
        x = torch.index_select(x, 0, plan.order)
    for offsets in plan.levels:
        x = torch.segment_reduce(x, "sum", offsets=offsets, unsafe=True)
    return x.reshape(shape)


def segment_sum(vals: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """(num_segments, ...) sums of the rows of `vals` (N, ...) by segment:
    `index_add_` on CPU tensors, the plan's fixed-order sum elsewhere."""
    if vals.shape[0] != plan.ids.numel():
        raise ValueError(f"{vals.shape[0]} rows for a plan of {plan.ids.numel()}")
    if vals.device.type == "cpu":
        return vals.new_zeros((plan.num_segments,) + vals.shape[1:]).index_add_(
            0, plan.ids, vals)
    return planned_sum(vals, plan)
