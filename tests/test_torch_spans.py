"""The port's spans (`utils/spans.py`) in bundle adjustment, the segment
plans and the MapBuilder, read back from torch.profiler on the CPU.

A span is a user annotation of whatever profiler runs, and nothing at all
when none does; the solver's iterates, counts and outputs are the same bits
either way."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from monocularsfm_torch.optim import bundle_adjust
from monocularsfm_torch.utils import spans
from monocularsfm_torch.utils.ring_problem import ring_problem

PHASES = ("ba.prepare", "ba.linearize", "ba.cg_step", "ba.step_eval")


@pytest.fixture(scope="module")
def pcg_problem():
    return ring_problem(8, 300, 4, row_width=2)[0]


def _user_spans(prof) -> list[tuple[str, int, int]]:
    """(name, start ns, end ns) of the profile's host user annotations."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CPU and ev.is_user_annotation():
            out.append((ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    return out


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _user_spans(prof)


def _count(sp, name):
    return sum(1 for n, _, _ in sp if n == name)


def _assert_same_bits(a, b):
    assert a.keys() == b.keys()
    for k, v in a.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, b[k]) and v.dtype == b[k].dtype, k
        else:
            assert v == b[k] and type(v) is type(b[k]), k


def _pcg(prob, **kw):
    kw = dict(dict(max_iterations=6, solve_mode="pcg", pcg_iters=50,
                   function_tolerance=0.0, parameter_tolerance=0.0,
                   gradient_tolerance=0.0), **kw)
    return lambda: bundle_adjust(prob, **kw)


def test_no_profiler_enters_no_span(pcg_problem, monkeypatch):
    entered = []
    real = spans._enter
    monkeypatch.setattr(spans, "_enter",
                        lambda name: entered.append(name) or real(name))
    with monkeypatch.context() as m:
        m.setattr(torch.profiler.record_function, "__enter__",
                  lambda self: entered.append(self.name))
        out = _pcg(pcg_problem)()
    assert entered == [] and out["cg_steps"] > 0
    traced, sp = _traced(_pcg(pcg_problem))
    assert len(entered) == len(sp) > 0
    _assert_same_bits(out, traced)


@pytest.mark.parametrize("pcg_iters", [3, 50])
def test_pcg_phases_and_reads_follow_the_solve(pcg_problem, pcg_iters):
    """One `ba.cg_step` a CG step, one `ba.linearize` and one `ba.step_eval`
    an LM iteration, each inside the `ba.solve`; a CG test before each step
    but the one `pcg_iters` cuts off, and one LM exit read an iteration.
    At 3 CG steps every iteration stops at `pcg_iters`, at 50 none does."""
    plain = _pcg(pcg_problem, pcg_iters=pcg_iters)()
    out, sp = _traced(_pcg(pcg_problem, pcg_iters=pcg_iters))
    _assert_same_bits(plain, out)
    it, steps = out["iterations"], out["cg_steps"]
    assert it == 6
    assert _count(sp, "ba.solve") == 1 and _count(sp, "ba.prepare") == 1
    assert _count(sp, "ba.cg_step") == steps
    assert _count(sp, "ba.linearize") == _count(sp, "ba.step_eval") == it
    if pcg_iters == 3:
        assert steps == 3 * it
        assert _count(sp, "host_read.cg_test") == steps
    else:
        assert 0 < steps < 50 * it
        assert _count(sp, "host_read.cg_test") == steps + it
    assert _count(sp, "host_read.lm_exit") == it
    assert _count(sp, "host_read.obs_select") == 1
    # CPU tensors sum by index_add_: their plans read nothing.
    assert _count(sp, "host_read.segment_plan") == 0
    (_, s0, e0), = [s for s in sp if s[0] == "ba.solve"]
    for name, s, e in sp:
        assert s0 <= s <= e <= e0, name
    # The phases follow one another and the reads lie inside them.
    phases = sorted((s, e, n) for n, s, e in sp if n in PHASES)
    assert all(a[1] <= b[0] for a, b in zip(phases, phases[1:]))
    for name, s, e in sp:
        if name.startswith("host_read."):
            assert any(ps <= s and e <= pe for ps, pe, _ in phases), name


def test_each_segment_prepares_once(pcg_problem):
    out, sp = _traced(_pcg(pcg_problem, max_iterations=5, dispatch_iters=2))
    assert out["iterations"] == 5
    assert _count(sp, "ba.solve") == 1
    assert _count(sp, "ba.prepare") == _count(sp, "host_read.obs_select") == 3
    assert _count(sp, "ba.linearize") == _count(sp, "host_read.lm_exit") == 5


def test_dense_path_has_no_cg_spans():
    prob = ring_problem(6, 200, 4)[0]
    solve = lambda: bundle_adjust(prob, max_iterations=3,  # noqa: E731
                                  function_tolerance=0.0)
    plain = solve()
    out, sp = _traced(solve)
    _assert_same_bits(plain, out)
    assert {n for n, _, _ in sp} == {"ba.solve", "ba.prepare",
                                     "host_read.obs_select", "host_read.lm_exit"}
    assert _count(sp, "host_read.lm_exit") == out["iterations"] == 3


def test_dense_path_on_the_cpu_has_no_lm_graph_spans():
    """The LM graph (optim/lm_graph.py) is the card's: a dense solve of
    many iterations on the CPU captures and replays nothing."""
    prob = ring_problem(4, 600, 4)[0]
    solve = lambda: bundle_adjust(prob, max_iterations=40,  # noqa: E731
                                  function_tolerance=1e-8)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)    # many tiny ops: a shared pool slows them
    try:
        plain = solve()
        out, sp = _traced(solve)
    finally:
        torch.set_num_threads(threads)
    _assert_same_bits(plain, out)
    assert out["iterations"] > 2
    assert _count(sp, "ba.lm_capture") == _count(sp, "ba.lm_replay") == 0
    assert _count(sp, "host_read.lm_exit") == out["iterations"]


@pytest.mark.parametrize("longest, reads", [(20, 1), (100, 2)])
def test_fixed_order_plan_reads(longest, reads):
    """The plan reads its ids' facts once, and the bags' count once more
    where a segment is longer than WIDTH rows."""
    from monocularsfm_torch.utils.segment import fixed_order_plan

    ids = torch.cat([torch.zeros(longest, dtype=torch.long),
                     torch.arange(1, 10)])[torch.randperm(longest + 9)]
    _, sp = _traced(lambda: fixed_order_plan(ids, 10))
    assert [n for n, _, _ in sp] == ["host_read.segment_plan"] * reads


def test_map_builder_phase_is_its_timer_and_a_span():
    from monocularsfm_torch.config import SfMConfig
    from monocularsfm_torch.reconstruction import MapBuilder

    b = MapBuilder(SfMConfig(), device="cpu")
    with b._phase("register"):
        pass
    untraced = b.timers["register"].elapsed
    assert untraced > 0

    def nested():
        with b._phase("filter"), b._phase("filter_pass"):
            torch.ones(4).sum()

    _, sp = _traced(nested)
    assert [n for n, _, _ in sp] == ["map_builder.filter", "map_builder.filter_pass"]
    (_, fs, fe), (_, ps, pe) = sp
    assert fs <= ps <= pe <= fe
    assert b.timers["filter"].elapsed >= b.timers["filter_pass"].elapsed > 0


def test_span_outside_a_profiler_is_inert():
    s = spans.span("x")
    assert s._handle is None
    s.close()
    with spans.span("y") as t:
        assert t._handle is None
