"""Each per-layer reader on a canned trace and canned unit records."""

from __future__ import annotations

import pytest

from sfmbench import harness
from sfmbench.lib.spans import SpanData
from sfmbench.lib.trace import TraceData

MS = 1_000_000  # ns


def ctx(device=(), records=(), window=(0, 1000 * MS), samples=(), spans=()):
    sd = SpanData(window, sorted(spans, key=lambda x: (x[1], -x[2])), [])
    trace = TraceData(window, list(device), list(samples), sd)
    return harness.MetricCtx(trace, list(records), trace.window_s, sd)


def read(name, c):
    return harness.metric_reader(name).read(c)


@pytest.mark.parametrize("name", ["device_idle_pct.ba",
                                  "device_idle_pct.reconstruct"])
def test_idle_share_is_the_union_of_device_intervals(name):
    # 100-300 and 200-400 overlap (300 ms busy), 900-1100 is half outside.
    dev = [("k1", 100 * MS, 300 * MS), ("k2", 200 * MS, 400 * MS),
           ("k3", 900 * MS, 1100 * MS)]
    assert read(name, ctx(dev)) == pytest.approx(60.0)


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
    # Two whole CG steps of 2 and 4 ms; the one cut by the window's end
    # does not count.
    steps = [("ba.cg_step", 10 * MS, 12 * MS), ("ba.cg_step", 20 * MS, 24 * MS),
             ("ba.cg_step", 999 * MS, 1001 * MS)]
    c = ctx(records=recs, spans=steps)
    assert read("ba.cg_step_ms", c) == pytest.approx(3.0)
    assert read("ba.lm_iters_per_solve", c) == pytest.approx(30.5)


# Two builds in the window, a third cut by its end.  Build 1 registers 16
# views (14 by PnP), build 2 registers 10 (8 by PnP).
BUILDS = [
    ("map_builder.total", 0, 400 * MS), ("map_builder.total", 450 * MS, 900 * MS),
    ("map_builder.total", 950 * MS, 1100 * MS),
    ("map_builder.register", 10 * MS, 40 * MS), ("map_builder.register", 60 * MS, 70 * MS),
    ("map_builder.register", 460 * MS, 520 * MS), ("map_builder.register", 990 * MS, 999 * MS),
    ("map_builder.triangulate", 40 * MS, 45 * MS), ("map_builder.triangulate", 520 * MS, 535 * MS),
    ("map_builder.global_ba", 100 * MS, 300 * MS), ("map_builder.global_ba", 600 * MS, 700 * MS),
    ("map_builder.local_ba", 300 * MS, 310 * MS),
    ("map_builder.filter", 310 * MS, 350 * MS), ("map_builder.filter_pass", 310 * MS, 320 * MS),
    ("map_builder.filter", 700 * MS, 720 * MS), ("map_builder.filter", 1000 * MS, 1050 * MS),
]


@pytest.mark.parametrize("name,value", [
    ("map_builder.register_ms_per_image", (30 + 10 + 60 + 9) / 22),
    ("map_builder.global_ba_ms_per_build", (200 + 100) / 2),
    ("map_builder.filter_ms_per_build", (40 + 20) / 2),
])
def test_map_builder_readers(name, value):
    recs = [{"registered": 16}, {"registered": 10}]
    assert read(name, ctx(records=recs, spans=BUILDS)) == pytest.approx(value)


def test_readers_find_nothing_in_an_empty_window():
    c = ctx(records=[])
    assert read("ba.cg_step_ms", c) is None
    assert read("ba.lm_iters_per_solve", c) is None
    for name in ("map_builder.register_ms_per_image",
                 "map_builder.global_ba_ms_per_build"):
        assert read(name, c) is None
        assert read(name, ctx(records=[{"registered": 2}], spans=BUILDS[:4])) is None
    empty = harness.MetricCtx(None, [], 0.0)
    for name in ("device_idle_pct.ba", "device_idle_pct.reconstruct",
                 "ba.cg_step_ms", "map_builder.filter_ms_per_build"):
        assert read(name, empty) is None
