"""The port's fixed-order segment sum (utils/segment.py) against a float64
numpy reference and against `index_add_`, on the CPU."""

import numpy as np
import pytest
import torch

from monocularsfm_torch.utils.segment import (
    fixed_order_plan,
    planned_sum,
    segment_plan,
    segment_sum,
)

# (rows, num_segments, largest id + 1): empty segments among the ids,
# every row in one segment, num_segments above the largest id, segments
# longer than WIDTH (summed in bags) beside short ones, no rows, ids that
# come sorted (no gather) with segments longer than WIDTH.
CASES = {
    "gaps": (2000, 60, 60),
    "one_segment": (5000, 1, 1),
    "above_largest_id": (300, 500, 40),
    "long_segments": (20000, 7, 7),
    "long_and_short": (3000, 400, 400),
    "no_rows": (0, 5, 5),
    "sorted": (5000, 9, 9),
}


def _inputs(case, trailing=(3, 2)):
    n, num_segments, ids_below = CASES[case]
    rng = np.random.default_rng(len(case))
    ids = rng.integers(0, ids_below, n)
    if case == "gaps":
        ids[ids % 7 == 3] = 0                  # segments 3, 10, ... stay empty
    if case == "long_and_short":
        ids[:300] = 17                         # one segment of 300+ rows
    if case == "sorted":
        ids = np.sort(ids)
    vals = rng.normal(size=(n,) + trailing).astype(np.float32)
    ref = np.zeros((num_segments,) + trailing)
    np.add.at(ref, ids, vals.astype(np.float64))
    return torch.from_numpy(ids), torch.from_numpy(vals), ref


@pytest.mark.parametrize("case", sorted(CASES))
def test_planned_sum_equals_float64_reference(case):
    """Within f32 rounding of a float64 sum (the largest row's ulp times
    the longest segment), with zeros in the empty segments."""
    ids, vals, ref = _inputs(case)
    plan = fixed_order_plan(ids, CASES[case][1])
    out = planned_sum(vals, plan)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    longest = max(int(np.bincount(ids.numpy()).max()) if len(ids) else 0, 1)
    tol = longest * np.finfo(np.float32).eps * np.abs(vals.numpy()).max(initial=1.0)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=tol)
    empty = np.setdiff1d(np.arange(CASES[case][1]), ids.numpy())
    assert (out.numpy()[empty] == 0).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_segment_sum_on_the_cpu_is_index_add(case):
    """On CPU tensors segment_sum is index_add_ bit for bit (the CPU's
    results against the JAX package do not move)."""
    ids, vals, _ = _inputs(case, trailing=(6, 6))
    num_segments = CASES[case][1]
    out = segment_sum(vals, segment_plan(ids, num_segments))
    ref = torch.zeros((num_segments, 6, 6)).index_add_(0, ids, vals)
    assert torch.equal(out, ref)


def test_plan_layout_and_checks():
    """The rows sorted by segment (stably), no order where the ids come
    sorted; a segment longer than WIDTH cut into bags of max(WIDTH,
    ceil(sqrt(longest))) rows, summed in two passes; a plan for CPU tensors
    that keeps only the ids; ids outside [0, num_segments) and a row count
    that is not the plan's raise."""
    ids = torch.tensor([4, 0, 4, 4, 2, 4, 4])
    flat = fixed_order_plan(ids, 6)
    assert flat.order.tolist() == [1, 4, 0, 2, 3, 5, 6]
    assert [o.tolist() for o in flat.levels] == [[0, 1, 1, 2, 2, 7, 7]]
    assert torch.equal(planned_sum(torch.ones(7), flat),
                       torch.tensor([1.0, 0, 1, 0, 5, 0]))
    in_order = fixed_order_plan(torch.tensor([0, 0, 2, 3, 3]), 5)
    assert in_order.order is None
    assert [o.tolist() for o in in_order.levels] == [[0, 2, 2, 3, 5, 5]]
    assert torch.equal(planned_sum(torch.arange(5.0), in_order),
                       torch.tensor([1.0, 0, 2, 7, 0]))
    ids = torch.tensor([2] * 40 + [0] * 3)
    plan = fixed_order_plan(ids, 3)
    assert plan.order.tolist() == [40, 41, 42] + list(range(40))
    assert [o.tolist() for o in plan.levels] == [[0, 3, 35, 43], [0, 1, 1, 3]]
    assert torch.equal(planned_sum(torch.ones(43), plan), torch.tensor([3.0, 0, 40]))
    plan = fixed_order_plan(torch.zeros(2000, dtype=torch.long), 1)
    assert plan.order is None         # ceil(sqrt(2000)) = 45 rows a bag
    assert plan.levels[0].tolist() == list(range(0, 2000, 45)) + [2000]
    cpu = segment_plan(ids, 3)
    assert cpu.order is None and cpu.levels == () and cpu.ids is not None
    with pytest.raises(ValueError, match="built for CPU tensors"):
        planned_sum(torch.ones(43), cpu)
    with pytest.raises(ValueError, match="outside"):
        fixed_order_plan(torch.tensor([0, 6]), 6)
    with pytest.raises(ValueError, match="outside"):
        fixed_order_plan(torch.tensor([-1, 2]), 6)
    with pytest.raises(ValueError, match="rows for a plan"):
        segment_sum(torch.ones(3), plan)
