"""Each per-layer reader on a canned trace and canned unit records."""

from __future__ import annotations

import pytest

from sfmbench import harness
from sfmbench.lib.trace import TraceData

MS = 1_000_000  # ns


def ctx(device=(), records=(), window=(0, 1000 * MS), samples=()):
    trace = TraceData(window, list(device), list(samples))
    return harness.MetricCtx(trace, list(records), trace.window_s)


def read(name, c):
    return harness.metric_reader(name).read(c)


def test_idle_share_is_the_union_of_device_intervals():
    # 100-300 and 200-400 overlap (300 ms busy), 900-1100 is half outside.
    dev = [("k1", 100 * MS, 300 * MS), ("k2", 200 * MS, 400 * MS),
           ("k3", 900 * MS, 1100 * MS)]
    assert read("device_idle_pct.ba", ctx(dev)) == pytest.approx(60.0)


def test_idle_gaps_are_named_by_the_host_samples():
    t = TraceData((0, 1000 * MS), [("k", 0, 500 * MS)],
                  [(600 * MS, "a.f"), (700 * MS, "a.f"), (800 * MS, "b.g"),
                   (900 * MS, "a.f")])
    gaps = dict(t.idle_gaps())
    assert gaps["a.f"] == pytest.approx(0.375) and gaps["b.g"] == pytest.approx(0.125)
    assert t.top_device_ops() == [["k", 0.5]]


def test_ba_readers():
    recs = [{"wall_s": 2.0, "cg_steps": 1000, "iterations": 30},
            {"wall_s": 2.2, "cg_steps": 1100, "iterations": 31}]
    c = ctx(records=recs)
    assert read("ba.ms_per_cg_step", c) == pytest.approx(2.0)
    assert read("ba.lm_iters_per_solve", c) == pytest.approx(30.5)


def test_readers_find_nothing_in_an_empty_window():
    c = ctx(records=[])
    assert read("ba.ms_per_cg_step", c) is None
    assert read("ba.lm_iters_per_solve", c) is None
    empty = harness.MetricCtx(None, [], 0.0)
    assert read("device_idle_pct.ba", empty) is None
