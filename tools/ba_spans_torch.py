"""Bundle adjustment's phases, host reads and launches on the card, read
from the port's spans in a torch.profiler trace.

    python3 tools/ba_spans_torch.py [--seconds 30] [--seed N] [--out FILE]
    python3 tools/ba_spans_torch.py --device cpu --small     (a rehearsal)

Builds the benchmark's `neu.global-ba` bundle (`sfmbench/stages/global_ba.py`:
1,329 cameras, 542,084 points, PCG at the MapBuilder's tolerances), solves
it once untraced and then back to back for `--seconds` under torch.profiler
(host and card), as the benchmark's traced window does, and reads from the
trace (`sfmbench/lib/spans.py`):

* the phase split: `ba.prepare` ms a solve, and the mean `ba.linearize`,
  CG loop and `ba.step_eval` spans.  The CG loop's spans are one
  `ba.cg_step` a CG step where it runs eagerly, or on the card one
  `ba.cg_block` a replay of its CUDA graph and one `ba.cg_capture` a solve
  (optim/pcg.py);
* host reads a solve, launch calls (kernels and graphs) a CG step, and
  the share of the window in which the card idles after a blocking read,
  beside the card's idle share as the benchmark reads it and the idle
  time by innermost span;
* checks: the spans in the window against the solves' own counts (one
  `ba.cg_step` a CG step, or one read a `ba.cg_block`; one `ba.linearize`
  and `ba.step_eval` an LM iteration, one `ba.solve` a solve), every
  traced solve's outputs equal bit for bit to the untraced one's, no
  span's name among the card's operations, and the phases' sum against
  the solves' mean wall;
* a span's host cost with no profiler running and under one, and the
  spans' cost in traced solves: `--pairs` pairs of single solves under
  torch.profiler, one with the spans on and one with them held off (their
  flag check patched to false), in turns, each with its wall and the
  card's idle share.

Prints (and writes to FILE) one JSON object with the card's name and power
limit; exits 1 if a check fails.
"""

from __future__ import annotations

import argparse
import bisect
import json
import pathlib
import sys
import time
import timeit

import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from sfmbench import harness  # noqa: E402
from sfmbench.lib import spans as S  # noqa: E402
from sfmbench.lib.common import State  # noqa: E402
from sfmbench.lib.trace import HARNESS_SPAN, _ns, read_profile  # noqa: E402
from sfmbench.stages import global_ba  # noqa: E402

CELL = "neu.global-ba"
PROGRAM_SPANS = ("ba.solve", "ba.prepare", "ba.linearize", "ba.cg_step",
                 "ba.cg_block", "ba.cg_capture", "ba.step_eval", "host_read.")
# Runtime calls that launch work: kernels, and a CUDA graph's replay.
LAUNCHES = S.LAUNCH_PREFIXES + ("cudaGraphLaunch", "cuGraphLaunch")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def span_cost_us(n: int = 20000) -> dict:
    """Host microseconds of one empty `with span(...)`, with no profiler
    running and under torch.profiler (CPU activity)."""
    from torch.profiler import ProfilerActivity, profile

    from monocularsfm_torch.utils.spans import span

    def one():
        with span("cost.probe"):
            pass

    off = timeit.timeit(one, number=n) / n * 1e6
    with profile(activities=[ProfilerActivity.CPU]):
        on = timeit.timeit(one, number=n) / n * 1e6
    return {"off_us": off, "on_us": on}


def traced_on_off(state, pairs: int, acts) -> dict:
    """Single traced solves with the spans on and off, in turns: wall
    seconds, ms a CG step and the card's idle share of each."""
    from torch.profiler import profile, record_function

    from monocularsfm_torch.utils import spans as P

    real = P._profiler_enabled
    out: dict[str, list] = {"on": [], "off": []}
    for i in range(pairs):
        for mode in ("on", "off") if i % 2 == 0 else ("off", "on"):
            P._profiler_enabled = real if mode == "on" else (lambda: False)
            try:
                with profile(activities=acts) as prof:
                    with record_function(HARNESS_SPAN):
                        rec = global_ba.unit(state)
            finally:
                P._profiler_enabled = real
            trace = read_profile(prof, [])
            del prof
            out[mode].append({
                "wall_s": rec["wall_s"],
                "ms_per_cg_step": 1e3 * rec["wall_s"] / max(rec["cg_steps"], 1),
                "idle_pct": 100.0 * (1.0 - trace.busy_s / trace.window_s)})
    return out


def same_bits(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        torch.equal(v, b[k]) if isinstance(v, torch.Tensor) else v == b[k]
        for k, v in a.items())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--seed", type=int, default=2 ** 31 + 1019)
    p.add_argument("--device", default="cuda")
    p.add_argument("--small", action="store_true",
                   help="the benchmark tests' small bundle (a CPU rehearsal)")
    p.add_argument("--pairs", type=int, default=3,
                   help="pairs of traced solves with the spans on and off")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from torch.profiler import ProfilerActivity, profile, record_function

    dev = "cuda:0" if args.device == "cuda" else args.device
    cuda = torch.device(dev).type == "cuda"
    if args.device == "cuda" and not torch.cuda.is_available():
        log("no CUDA card: pass --device cpu to rehearse")
        return 2
    cell = harness.find_cell(harness.load_manifest(), CELL)
    config, traffic = cell.config, cell.traffic
    if args.small:
        from sfmbench.tests.conftest import SMALL_CONFIG, SMALL_TRAFFIC

        config = harness.deep_merge(config, SMALL_CONFIG["neu"])
        traffic = harness.deep_merge(traffic, SMALL_TRAFFIC["global_ba"])
    result = {"card": harness.card_line() if cuda else "cpu",
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "span_cost": span_cost_us()}
    state = global_ba.setup(State(config, traffic, args.seed, dev, log))
    global_ba.warm_up(state)
    global_ba.unit(state)
    plain = state.program["result"]

    records, equal = [], []
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(HARNESS_SPAN):
            start = time.perf_counter()
            while True:
                t0 = time.perf_counter()
                rec = global_ba.unit(state)
                rec["t0"], rec["t1"] = t0, time.perf_counter()
                records.append(rec)
                equal.append(same_bits(plain, state.program["result"]))
                if rec["t1"] - start >= args.seconds:
                    break
    t0 = time.perf_counter()
    trace = read_profile(prof, [])
    sd = S.read_spans(prof, trace.window)
    launch_names = S.launch_names(prof)
    launch_calls = sorted(_ns(ev, "start") for ev in prof.profiler.kineto_results.events()
                          if ev.name().startswith(LAUNCHES))
    del prof
    result["read_s"] = time.perf_counter() - t0

    n = len(records)
    iters = sum(r["iterations"] for r in records)
    steps = sum(r["cg_steps"] for r in records)
    wall = sum(r["wall_s"] for r in records) / n
    graph = bool(sd.named("ba.cg_block"))
    loop = "ba.cg_block" if graph else "ba.cg_step"
    solves = len(sd.named("ba.solve"))
    phases = {
        "ba.prepare_ms_per_solve": S.prepare_ms_per_solve(sd),
        "ba.linearize_ms_per_iter": S.mean_ms(sd, "ba.linearize"),
        "ba.cg_loop_ms_per_solve": (S.total_ms(sd, loop) or 0.0) / max(solves, 1),
        "ba.step_eval_ms_per_iter": S.mean_ms(sd, "ba.step_eval"),
    }
    if graph:
        phases["ba.cg_capture_ms_per_solve"] = (
            S.total_ms(sd, "ba.cg_capture") or 0.0) / max(solves, 1)
    loop_spans = sd.named(loop)
    in_loop = sum(bisect.bisect_left(launch_calls, e)
                  - bisect.bisect_left(launch_calls, s) for s, e in loop_spans)
    metrics = dict(phases, **{
        "ba.cg_step_ms": S.mean_ms(sd, "ba.cg_step"),
        "ba.cg_block_ms": S.mean_ms(sd, "ba.cg_block"),
        "ba.host_reads_per_solve": S.host_reads_per_solve(sd),
        "ba.launches_per_cg_step": in_loop / steps if steps else None,
        "device_idle_pct.ba.after_read": S.idle_after_read_pct(trace, sd),
        # The benchmark's own readers, for the same window.
        "device_idle_pct.ba": 100.0 * (1.0 - trace.busy_s / trace.window_s),
        "ba.ms_per_cg_step": 1e3 * wall * n / steps if steps else None,
    })
    reads: dict[str, int] = {}
    for name, s, e in sd.spans:
        if name.startswith(S.READ_PREFIX) and trace.window[0] <= s and e <= trace.window[1]:
            reads[name] = reads.get(name, 0) + 1
    counted = {name: len(sd.named(name)) for name in
               ("ba.solve", "ba.prepare", "ba.linearize", "ba.cg_step",
                "ba.cg_block", "ba.cg_capture", "ba.step_eval")}
    block_reads = sum(len(sd.inside(o, lambda nm: nm == "host_read.cg_test"))
                      for o in loop_spans)
    on_card = sorted({nm for nm, _, _ in trace.device
                      if nm.startswith(PROGRAM_SPANS)})
    it_per, st_per = iters / n, steps / n
    phase_sum_ms = None
    if all(v is not None for v in phases.values()):
        phase_sum_ms = (phases["ba.prepare_ms_per_solve"]
                        + it_per * (phases["ba.linearize_ms_per_iter"]
                                    + phases["ba.step_eval_ms_per_iter"])
                        + phases["ba.cg_loop_ms_per_solve"]
                        + phases.get("ba.cg_capture_ms_per_solve", 0.0))
    checks = {
        "cg_loop_spans_follow_the_steps": (
            block_reads == len(loop_spans) and counted["ba.cg_step"] == 0
            and counted["ba.cg_capture"] == n if graph
            else counted["ba.cg_step"] == steps),
        "linearize_spans_eq_iterations": counted["ba.linearize"] == iters,
        "step_eval_spans_eq_iterations": counted["ba.step_eval"] == iters,
        "solve_spans_eq_solves": counted["ba.solve"] == n,
        "all_metrics_read": all(v is not None for k, v in metrics.items()
                                if k != ("ba.cg_step_ms" if graph else "ba.cg_block_ms")),
        "phase_sum_within_3pct_of_wall": (
            phase_sum_ms is not None and abs(phase_sum_ms / (1e3 * wall) - 1) <= 0.03),
        "traced_outputs_equal_untraced": all(equal),
        "no_span_among_device_ops": not on_card,
    }
    result.update(
        solves=n, iterations=sorted({r["iterations"] for r in records}),
        cg_steps=sorted({r["cg_steps"] for r in records}),
        walls_s=[r["wall_s"] for r in records], window_s=trace.window_s,
        busy_s=trace.busy_s, spans_in_window=counted, host_reads=reads,
        metrics=metrics, phase_sum_ms=phase_sum_ms, mean_wall_ms=1e3 * wall,
        idle_by_span_s=S.idle_by_span(trace, sd), launch_calls=launch_names,
        span_names_on_card=on_card, checks=checks,
        device_ops=trace.top_device_ops(), kernels_in_window=trace.kernel_count())
    result["traced_on_off"] = traced_on_off(state, args.pairs, acts)
    text = json.dumps(result, indent=1)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(text)
    print(json.dumps(result))
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        log(f"checks failed: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
