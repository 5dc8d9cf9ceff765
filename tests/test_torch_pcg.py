"""The CG loop of the PCG path (optim/pcg.py) on the CPU: the solver stays
eager there, one blocking read a stop test, and the graph's masked body, run
eagerly, walks the eager loop's iterates bit for bit and changes nothing
past the stop.  The graph itself runs on the card (tests/test_torch_cuda.py)."""

import pytest
import torch

from monocularsfm_torch.optim import ba, bundle_adjust, pcg
from monocularsfm_torch.utils import spans
from monocularsfm_torch.utils.ring_problem import ring_problem


@pytest.fixture(scope="module")
def problem():
    return ring_problem(8, 300, 4, row_width=2)[0]


def _cg_inputs(prob, monkeypatch):
    """The CG loop's inputs (plan, W, Vi, U_d, Uinv, rhs, tol2) in the
    first LM iteration of a PCG solve."""
    seen = []
    real = ba.cg_eager

    def record(*args, **kw):
        seen.append(args)
        return real(*args, **kw)

    monkeypatch.setattr(ba, "cg_eager", record)
    bundle_adjust(prob, max_iterations=1, solve_mode="pcg", pcg_iters=5)
    plan, _, *inputs = seen[0]
    return plan, inputs


@pytest.mark.parametrize("pcg_iters", [3, 50])
def test_the_cpu_path_stays_eager(problem, monkeypatch, pcg_iters):
    """No graph on the CPU: one `ba.cg_step` a step and `cg_reads` equal
    to the stop tests read, a test before each step but those that
    `pcg_iters` cuts off (at 3 every LM iteration stops there, at 50
    none does)."""
    names = []

    def opened(name):
        names.append(name)
        return spans.span(name)

    monkeypatch.setattr(ba, "CGGraph", None)      # a graph would raise
    monkeypatch.setattr(pcg, "span", opened)
    out = bundle_adjust(problem, max_iterations=4, solve_mode="pcg",
                        pcg_iters=pcg_iters, function_tolerance=0.0,
                        parameter_tolerance=0.0, gradient_tolerance=0.0)
    it, steps = out["iterations"], out["cg_steps"]
    assert it == 4 and names.count("ba.cg_step") == steps
    assert "ba.cg_block" not in names
    assert out["cg_reads"] == names.count("host_read.cg_test")
    if pcg_iters == 3:
        assert steps == 3 * it and out["cg_reads"] == steps
    else:
        assert 0 < steps < 50 * it and out["cg_reads"] == steps + it


@pytest.mark.parametrize("case", ["rtol", "cap", "zero_rhs"])
def test_masked_body_walks_the_eager_iterates(problem, monkeypatch, case):
    """The graph's body, run eagerly here, past the stop: the eager loop's
    x and k bit for bit, and the flag shut."""
    plan, (W, Vi, U_d, Uinv, rhs, tol2) = _cg_inputs(problem, monkeypatch)
    n = 40 if case == "rtol" else 12
    if case != "rtol":
        tol2 = torch.zeros_like(tol2)
    if case == "zero_rhs":
        rhs = torch.zeros_like(rhs)
    x, k, reads = pcg.cg_eager(plan, n, W, Vi, U_d, Uinv, rhs, tol2)
    want_k, want_reads = {"rtol": (k, k + 1), "cap": (n, n),
                          "zero_rhs": (0, 1)}[case]
    assert (k, reads) == (want_k, want_reads) and (case != "rtol" or 0 < k < n)
    g = pcg.CGGraph(plan, n)
    inputs = (W, Vi, U_d, Uinv, tol2)
    g._allocate(inputs, rhs)
    g._load(inputs, rhs)
    for _ in range(n + 3):
        g._masked_body()
    assert torch.equal(g.iterates[0], x)
    assert g.state.tolist() == [0, k]


@pytest.mark.parametrize("pcg_iters, steps", [
    (1, 1), (20, 20), (32, 32), (33, 17), (64, 32), (65, 22), (100, 25)])
def test_block_steps(pcg_iters, steps):
    """At most 32 bodies a replay, and a whole number of replays reaches
    the cap."""
    assert pcg.block_steps(pcg_iters) == steps
    assert steps <= 32 and -(-pcg_iters // steps) * steps - pcg_iters < steps
