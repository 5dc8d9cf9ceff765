"""The dense path's LM iteration as a CUDA graph (optim/lm_graph.py), on the CPU.

On the card without a process group a dense solve runs its first LM
iteration eagerly, captures the loop body over static buffers once, and
replays it once an iteration.  Nothing is captured on the CPU: `Eager`
below is `LMGraph` with the capture and the card's stream taken out, so
each replay runs the static-buffer body eagerly.  These tests hold that
body, which writes every next state into its buffer, to the eager loop
bit for bit; tests/test_torch_cuda.py holds the captured graph to it on
the card.  They also hold that the CPU and a process group build no graph,
and the benchmark's reader of the launches a solve makes."""

import pytest
import torch

from monocularsfm_torch.optim import ba, lm_graph
from monocularsfm_torch.utils.ring_problem import ring_problem

# The MapBuilder's global-BA settings: a bundle of fewer than
# `min_images_tight` images takes 1e-8 and 200 iterations, else 1e-6 and 100.
SMALL = dict(max_iterations=200, function_tolerance=1e-8)
LARGE = dict(max_iterations=100, function_tolerance=1e-6)

# name: (cameras, points, keywords)
CASES = {
    "small_bundle": (4, 1500, SMALL),
    "ring16": (16, 3000, LARGE),
    "refine_focal": (4, 1500, dict(SMALL, refine_focal=True)),
    "first_stops": (8, 1500, dict(LARGE, gradient_tolerance=1e30)),
    "segments": (4, 1500, dict(SMALL, dispatch_iters=5)),
}

STATE = ("R", "t", "X", "K", "cost_initial", "cost_final", "radius")
COUNTS = ("iterations", "converged", "cg_steps", "cg_reads")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: a solve here is hundreds of LM iterations of
    tiny ops, which a thread pool shared with the suite's other workers
    slows a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def case_problem(name):
    cams, points, kw = CASES[name]
    return ring_problem(cams, points, 4)[0], kw


def assert_same_solve(a, b):
    for k in STATE:
        assert torch.equal(a[k], b[k]), k
    for k in COUNTS:
        assert a[k] == b[k], k


class Eager(lm_graph.LMGraph):
    """LMGraph on CPU tensors: no side stream, and a "replay" runs the
    static-buffer body eagerly and writes its stop flag where the graph's
    would lie.  Counts its captures and replays."""

    def __init__(self, body, state):
        super().__init__(body, state)
        self.captures = self.replays = 0

    def __call__(self, it, max_iterations):
        return self.loop(it, max_iterations)

    def _capture(self):
        self.captures += 1
        stop = torch.empty((), dtype=torch.bool)

        def replay():
            self.replays += 1
            stop.copy_(self.step())

        return replay, stop

    def _read(self, stop):
        return bool(stop)


def solve(prob, monkeypatch, graph: bool, **kw):
    """bundle_adjust with every LMGraph an `Eager` one, and with `graph` the
    graph's path taken on the CPU: (the result, the graphs built)."""
    made = []

    def record(body, state):
        made.append(Eager(body, state))
        return made[-1]

    with monkeypatch.context() as m:
        m.setattr(ba, "LMGraph", record)
        if graph:
            m.setattr(ba, "_lm_graph_on", lambda dev, group, mode: True)
        out = ba.bundle_adjust(prob, **kw)
    return out, made


@pytest.mark.parametrize("case", list(CASES))
def test_static_buffer_body_walks_the_eager_loop(monkeypatch, case):
    """The graph's body, run in place of each replay, against the eager
    loop: R, t, X, K, costs, radius and the counts bit for bit, one graph a
    segment, a capture only where a segment goes past its first iteration,
    and one replay an iteration after the first."""
    prob, kw = case_problem(case)
    eager, none = solve(prob, monkeypatch, graph=False, **kw)
    assert none == []                   # the CPU builds no graph
    out, made = solve(prob, monkeypatch, graph=True, **kw)
    assert_same_solve(out, eager)
    it = out["iterations"]
    segments = -(-it // kw.get("dispatch_iters", it))
    assert len(made) == segments
    assert sum(g.replays for g in made) == it - segments
    assert [g.captures for g in made] == [int(g.replays > 0) for g in made]
    if case == "small_bundle":
        # Under one ulp of f32, 1e-8 stops only at the smallest radius.
        assert 50 < it < 200 and out["converged"]
        assert float(out["radius"]) < 1e-12
    if case == "first_stops":
        assert it == 1 and out["converged"] and made[0].captures == 0
    if case == "segments":
        assert segments > 5


def test_one_iteration_left_makes_no_capture(monkeypatch):
    """A segment of one iteration stops at `max_iterations` eagerly."""
    prob, kw = case_problem("small_bundle")
    kw = dict(kw, max_iterations=1)
    eager, _ = solve(prob, monkeypatch, graph=False, **kw)
    out, (g,) = solve(prob, monkeypatch, graph=True, **kw)
    assert_same_solve(out, eager)
    assert out["iterations"] == 1 and not out["converged"]
    assert g.captures == g.replays == 0


def test_graph_only_on_the_card_without_a_group():
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert ba._lm_graph_on(cuda, None, "dense")
    assert not ba._lm_graph_on(cpu, None, "dense")
    assert not ba._lm_graph_on(cuda, object(), "dense")
    assert not ba._lm_graph_on(cuda, None, "pcg")


def test_a_process_group_builds_no_graph(monkeypatch, tmp_path):
    """A dense solve under a gloo group of one, with the device test passed
    as on the card: the group alone keeps the loop eager."""
    import torch.distributed as dist

    real = ba._lm_graph_on
    monkeypatch.setattr(ba, "_lm_graph_on", lambda dev, group, mode: real(
        torch.device("cuda", 0), group, mode))
    prob, kw = case_problem("ring16")
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        made = []
        monkeypatch.setattr(ba, "LMGraph", lambda *a: made.append(a))
        out = ba.bundle_adjust(prob, group=dist.group.WORLD, **kw)
    finally:
        dist.destroy_process_group()
    assert made == [] and out["iterations"] > 1


def test_spans_of_the_graph_path(monkeypatch):
    """One `ba.lm_capture` a graph, one `ba.lm_replay` a replay with its
    `host_read.lm_exit` inside; a read an iteration in all."""
    from torch.profiler import ProfilerActivity, profile

    prob, kw = case_problem("ring16")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out, (g,) = solve(prob, monkeypatch, graph=True, **kw)
    sp = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
          for e in prof.profiler.kineto_results.events()
          if e.is_user_annotation()]
    names = [n for n, _, _ in sp]
    assert names.count("ba.lm_capture") == 1
    assert names.count("ba.lm_replay") == g.replays == out["iterations"] - 1 > 0
    assert names.count("host_read.lm_exit") == out["iterations"]
    for _, s, e in (x for x in sp if x[0] == "ba.lm_replay"):
        assert sum(1 for n, s2, e2 in sp
                   if n == "host_read.lm_exit" and s <= s2 <= e2 <= e) == 1


def test_launches_per_solve_reader():
    """sfmbench's `ba.launches_per_solve`: the launch calls that start
    inside each `ba.solve`, averaged over the solves; none without one."""
    from sfmbench.harness import metric_reader
    from sfmbench.lib.spans import span_data

    read = metric_reader("ba.launches_per_solve").read

    class Ctx:
        def __init__(self, spans):
            self.spans = spans

    sd = span_data((0, 100), [("ba.solve", 10, 20), ("ba.solve", 30, 60),
                              ("ba.prepare", 11, 12), ("ba.solve", 90, 110)],
                   [5, 10, 15, 19, 20, 31, 70, 95])
    assert read(Ctx(sd)) == (3 + 1) / 2     # the third solve ends outside
    assert read(Ctx(span_data((0, 100), [], [1, 2]))) is None
    assert read(Ctx(None)) is None
