"""The span readers (`lib/spans.py`) on a canned trace, and the profile
reader on canned profiler events."""

from __future__ import annotations

import types

import pytest
from torch.autograd import DeviceType

from sfmbench.lib import spans as S
from sfmbench.lib.trace import HARNESS_SPAN, TraceData, read_profile

MS = 1_000_000  # ns


def _ms(*spans):
    return [(n, s * MS, e * MS) for n, s, e in spans]


# A window of 100 ms.  The solve from 30 to 90 ms lies wholly inside it;
# those starting at -10 and 95 ms are cut by its edges and do not count.
SPANS = _ms(
    ("ba.solve", -10, 20), ("ba.cg_step", -5, 5), ("ba.cg_step", 5, 15),
    ("ba.solve", 30, 90),
    ("ba.prepare", 30, 40), ("host_read.obs_select", 32, 34),
    ("host_read.segment_plan", 36, 38),
    ("ba.linearize", 40, 50), ("host_read.cg_test", 48, 50),
    ("ba.cg_step", 50, 60), ("host_read.cg_test", 56, 60),
    ("ba.cg_step", 60, 66), ("host_read.cg_test", 64, 66),
    ("ba.step_eval", 66, 90), ("host_read.lm_exit", 86, 90),
    ("ba.solve", 95, 120), ("ba.prepare", 95, 99))
# Launches in the cut step (3), the first whole step (8), the linearization
# (41), the second step (51-53) and the third (61, 62).
LAUNCHES = [t * MS for t in (3, 8, 41, 51, 52, 53, 61, 62)]
# The card idles from 49 (inside a CG test's read) to 52, from 53 (the host
# launching, no read) to 55, from 65 (a read) to 70, and from 92 (after the
# solve, in no span) to the window's end.
DEVICE = _ms(("k", 0, 49), ("k", 52, 53), ("k", 55, 65), ("k", 70, 92))


@pytest.fixture
def canned():
    window = (0, 100 * MS)
    sd = S.SpanData(window, sorted(SPANS, key=lambda x: (x[1], -x[2])), LAUNCHES)
    return TraceData(window, DEVICE, []), sd


def test_phase_readers(canned):
    _, sd = canned
    assert S.prepare_ms_per_solve(sd) == pytest.approx(10.0)
    assert S.mean_ms(sd, "ba.linearize") == pytest.approx(10.0)
    assert S.mean_ms(sd, "ba.cg_step") == pytest.approx((10 + 10 + 6) / 3)
    assert S.mean_ms(sd, "ba.step_eval") == pytest.approx(24.0)


def test_counters(canned):
    _, sd = canned
    assert S.host_reads_per_solve(sd) == pytest.approx(6.0)
    assert S.launches_per_cg_step(sd) == pytest.approx((1 + 3 + 2) / 3)


def test_idle_after_reads_and_by_span(canned):
    trace, sd = canned
    assert S.idle_after_read_pct(trace, sd) == pytest.approx(8.0)
    by = S.idle_by_span(trace, sd)
    want = {"host_read.cg_test": 0.002, "ba.cg_step": 0.004,
            "ba.step_eval": 0.004, S.NONE: 0.003, "ba.prepare": 0.004,
            "ba.solve": 0.001}
    assert by.keys() == want.keys()
    for k, v in want.items():
        assert by[k] == pytest.approx(v), k
    assert sum(by.values()) == pytest.approx(100 * 1e-3 - trace.busy_s)


def test_readers_find_nothing_without_spans(canned):
    trace, _ = canned
    empty = S.SpanData(trace.window, [], [])
    assert S.prepare_ms_per_solve(empty) is None
    assert S.mean_ms(empty, "ba.cg_step") is None
    assert S.host_reads_per_solve(empty) is None
    assert S.launches_per_cg_step(empty) is None
    assert S.idle_after_read_pct(trace, empty) is None
    assert S.idle_by_span(trace, empty) == {S.NONE: pytest.approx(0.018)}
    none = TraceData((0, 0), [], [])
    assert S.idle_after_read_pct(none, S.SpanData((0, 0), SPANS, [])) is None


def _event(name, start_ms, dur_ms, device=DeviceType.CPU, user=False):
    return types.SimpleNamespace(
        name=lambda: name, device_type=lambda: device,
        start_ns=lambda: int(start_ms * MS), duration_ns=lambda: int(dur_ms * MS),
        is_user_annotation=lambda: user)


def test_profile_readers_keep_annotations_off_the_card():
    events = [
        _event(HARNESS_SPAN, 0, 100, user=True),
        _event("ba.cg_step", 10, 5, user=True),
        _event("aten::add", 11, 1),
        _event("cudaLaunchKernel", 11.5, 0.01),
        _event("cuLaunchKernelEx", 12, 0.01),
        _event("cudaMemcpyAsync", 13, 0.01),
        _event("k", 12, 2, device=DeviceType.CUDA),
        # The card's copy of the host's annotation.
        _event("ba.cg_step", 12, 2, device=DeviceType.CUDA, user=True),
    ]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    trace = read_profile(prof, [])
    assert trace.device == [("k", 12 * MS, 14 * MS)]
    sd = S.read_spans(prof, trace.window)
    assert sd.spans == [("ba.cg_step", 10 * MS, 15 * MS)]
    assert sd.launches == [int(11.5 * MS), 12 * MS]
    assert S.launches_per_cg_step(sd) == 2.0


def _recorded():
    """A traced window of the small neu.global-ba run on the card, as
    profiler events, with what the parent commit's `read_profile` and
    `device_idle_pct.ba` reader read from it."""
    import gzip
    import json
    import pathlib

    path = pathlib.Path(__file__).parent / "data" / "neu_small_card_trace.json.gz"
    with gzip.open(path, "rt") as f:
        d = json.load(f)
    def event(i, host, s, dur, user):
        return types.SimpleNamespace(
            name=lambda: d["names"][i], start_ns=lambda: s,
            duration_ns=lambda: dur, is_user_annotation=lambda: bool(user),
            device_type=lambda: DeviceType.CPU if host else DeviceType.CUDA)

    events = [event(*e) for e in d["events"]]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    return prof, [tuple(s) for s in d["samples"]], d["parent_readings"]


def test_recorded_trace_reads_as_before_the_spans():
    from sfmbench import harness

    prof, samples, before = _recorded()
    trace = read_profile(prof, samples)
    assert list(trace.window) == before["window"]
    assert len(trace.device) == before["device"]
    assert trace.busy_s == before["busy_s"]
    assert trace.top_device_ops() == before["top_device_ops"]
    assert [list(g) for g in trace.idle_gaps()] == before["idle_gaps"]
    ctx = harness.MetricCtx(trace, [], trace.window_s, trace.spans)
    assert (harness.metric_reader("device_idle_pct.ba").read(ctx)
            == before["device_idle_pct.ba"])
    # The same pass found the program's spans and launches, as the tool's
    # reader does.
    sd = S.read_spans(prof, trace.window)
    assert trace.spans == sd and sd.named("ba.cg_step") and sd.launches
    steps = sd.named("ba.cg_step")
    assert harness.metric_reader("ba.cg_step_ms").read(ctx) == pytest.approx(
        1e-6 * sum(e - s for s, e in steps) / len(steps))
