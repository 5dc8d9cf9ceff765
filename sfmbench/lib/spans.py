"""The program's spans and the host's kernel launches in a torch.profiler
trace, and the numbers of bundle adjustment's and the MapBuilder's phases
read from them.

The port marks its phases and its blocking device-to-host reads with user
annotations of torch.profiler (`monocularsfm_torch/utils/spans.py`): `ba.solve`,
`ba.prepare`, `ba.linearize`, `ba.cg_step`, `ba.step_eval`, a leaf
`host_read.<site>` around each read, and `map_builder.<phase>` around each
phase of a reconstruction.  They lie on the profiler's clock, as
the card's operations of `trace.read_profile` and the runtime's launch calls
do, so the three line up.

Only spans wholly inside the window count; a reader gives None where the
window holds nothing to read.
"""

from __future__ import annotations

import bisect
import dataclasses

from sfmbench.lib.trace import HARNESS_SPAN, TraceData, _ns

# The CUDA API calls that launch a kernel (cudaLaunchKernel,
# cudaLaunchKernelExC, cuLaunchKernel, cuLaunchKernelEx).
LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel")
READ_PREFIX = "host_read."
NONE = "(none)"


@dataclasses.dataclass
class SpanData:
    window: tuple[int, int]                    # ns
    spans: list[tuple[str, int, int]]          # (name, start ns, end ns)
    launches: list[int]                        # start ns, sorted

    def named(self, name: str) -> list[tuple[int, int]]:
        """(start, end) of the spans called `name` wholly inside the window."""
        lo, hi = self.window
        return [(s, e) for n, s, e in self.spans
                if n == name and lo <= s and e <= hi]

    def inside(self, outer: tuple[int, int], pred) -> list[tuple[str, int, int]]:
        s0, e0 = outer
        return [(n, s, e) for n, s, e in self.spans
                if pred(n) and s0 <= s and e <= e0]


def read_spans(prof, window: tuple[int, int]) -> SpanData:
    """The program's host user annotations (all but the harness's window)
    and the launch calls' start times, from a finished torch.profiler."""
    from torch.autograd import DeviceType

    spans, launches = [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CPU:
            add_host_event(ev, ev.name(), spans, launches)
    return span_data(window, spans, launches)


def add_host_event(ev, name: str, spans: list, launches: list) -> None:
    """File one host event of a profile: a launch call's start time, or a
    user annotation of the program as (name, start, end)."""
    if name.startswith(LAUNCH_PREFIXES):
        launches.append(_ns(ev, "start"))
    elif name != HARNESS_SPAN and ev.is_user_annotation():
        s = _ns(ev, "start")
        spans.append((name, s, s + int(_ns(ev, "duration"))))


def span_data(window: tuple[int, int], spans: list, launches: list) -> SpanData:
    spans.sort(key=lambda x: (x[1], -x[2]))
    return SpanData(window, spans, sorted(launches))


def launch_names(prof) -> dict[str, int]:
    """Count of each host runtime call whose name says it launches."""
    out: dict[str, int] = {}
    for ev in prof.profiler.kineto_results.events():
        if "Launch" in ev.name():
            out[ev.name()] = out.get(ev.name(), 0) + 1
    return out


def mean_ms(sd: SpanData, name: str) -> float | None:
    """Mean length of the spans called `name`, in ms."""
    spans = sd.named(name)
    if not spans:
        return None
    return 1e-6 * sum(e - s for s, e in spans) / len(spans)


def total_ms(sd: SpanData, name: str) -> float | None:
    """Summed length of the spans called `name`, in ms."""
    spans = sd.named(name)
    if not spans:
        return None
    return 1e-6 * sum(e - s for s, e in spans)


def ms_per_build(sd: SpanData, name: str) -> float | None:
    """`total_ms` of `name` over the number of builds, the
    `map_builder.total` spans of the window."""
    total, builds = total_ms(sd, name), len(sd.named("map_builder.total"))
    if total is None or not builds:
        return None
    return total / builds


def prepare_ms_per_solve(sd: SpanData) -> float | None:
    """`ba.prepare` ms of each `ba.solve` (its segments summed), averaged
    over the solves."""
    solves = sd.named("ba.solve")
    if not solves:
        return None
    per = [sum(e - s for _, s, e in sd.inside(o, lambda n: n == "ba.prepare"))
           for o in solves]
    return 1e-6 * sum(per) / len(per)


def host_reads_per_solve(sd: SpanData) -> float | None:
    solves = sd.named("ba.solve")
    if not solves:
        return None
    reads = sum(len(sd.inside(o, lambda n: n.startswith(READ_PREFIX)))
                for o in solves)
    return reads / len(solves)


def launches_per_cg_step(sd: SpanData) -> float | None:
    steps = sd.named("ba.cg_step")
    if not steps:
        return None
    t = sd.launches
    n = sum(bisect.bisect_left(t, e) - bisect.bisect_left(t, s) for s, e in steps)
    return n / len(steps)


def innermost(sd: SpanData) -> list[tuple[int, int, str]]:
    """The window cut into pieces (start, end, name), each named by the
    innermost span over it, or NONE where no span is.  The program's spans
    nest (one thread opens them all)."""
    lo, hi = sd.window
    marks: list[tuple[int, int, int]] = []      # (time, 0 end / 1 start, index)
    for i, (_, s, e) in enumerate(sd.spans):
        if e > lo and s < hi:
            marks += [(max(s, lo), 1, i), (min(e, hi), 0, i)]
    # Ends before starts at one time; outer spans (sorted first) open first.
    marks.sort()
    pieces, open_, t = [], [], lo
    for when, kind, i in marks:
        if when > t:
            pieces.append((t, when, sd.spans[open_[-1]][0] if open_ else NONE))
            t = when
        if kind:
            open_.append(i)
        else:
            open_.remove(i)
    if hi > t:
        pieces.append((t, hi, NONE))
    return pieces


def idle_gaps(trace: TraceData) -> list[tuple[int, int]]:
    """The stretches of the window in which no operation ran on the card."""
    lo, hi = trace.window
    gaps, prev = [], lo
    for s, e in trace.busy_intervals():
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if hi > prev:
        gaps.append((prev, hi))
    return gaps


def idle_by_span(trace: TraceData, sd: SpanData) -> dict[str, float]:
    """Seconds of the card's idle time under each innermost span, by
    overlap (NONE: under no span)."""
    pieces = innermost(sd)
    out: dict[str, float] = {}
    j = 0
    for gs, ge in idle_gaps(trace):
        while j < len(pieces) and pieces[j][1] <= gs:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < ge:
            ps, pe, name = pieces[k]
            out[name] = out.get(name, 0.0) + 1e-9 * (min(pe, ge) - max(ps, gs))
            k += 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def idle_after_read_pct(trace: TraceData, sd: SpanData) -> float | None:
    """100 x the idle time in gaps that begin inside a `host_read.*` span,
    over the window: the card waiting for the host after a blocking read."""
    if trace.window_s <= 0 or not sd.spans:
        return None
    pieces = innermost(sd)
    starts = [p[0] for p in pieces]
    idle = 0
    for gs, ge in idle_gaps(trace):
        i = bisect.bisect_right(starts, gs) - 1
        if i >= 0 and pieces[i][2].startswith(READ_PREFIX):
            idle += ge - gs
    return 100.0 * 1e-9 * idle / trace.window_s
