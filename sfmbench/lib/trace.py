"""The traced window: torch.profiler's device events and a host sampler.

The profiler gives every operation that ran on the card (kernels, copies,
fills) with its start and end; the sampler, a thread that reads the main
thread's stack every few milliseconds, names what the host was doing in
each stretch where the card was idle.  Both clocks are the wall clock in
nanoseconds, so the two line up.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time

HARNESS_SPAN = "sfmbench.window"
SAMPLE_S = 0.005


class HostSampler:
    """Samples the main thread's innermost frame of the port (or, where
    none is on the stack, the innermost frame at all) every SAMPLE_S."""

    def __init__(self, package: str = "monocularsfm_torch"):
        self.package = package
        self.samples: list[tuple[int, str]] = []
        self._stop = threading.Event()
        self._main = threading.main_thread().ident
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _label(self, frame) -> str:
        inner = None
        f = frame
        while f is not None:
            mod = f.f_globals.get("__name__", "?")
            if inner is None:
                inner = f"{mod}.{f.f_code.co_name}"
            if mod.split(".")[0] == self.package:
                return f"{mod}.{f.f_code.co_name}"
            f = f.f_back
        return inner or "?"

    def _run(self):
        while not self._stop.wait(SAMPLE_S):
            frame = sys._current_frames().get(self._main)
            if frame is not None:
                self.samples.append((time.time_ns(), self._label(frame)))

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10.0)


@dataclasses.dataclass
class TraceData:
    window: tuple[int, int]                    # ns
    device: list[tuple[str, int, int]]         # (name, start ns, end ns)
    samples: list[tuple[int, str]]
    spans: object = None                       # lib.spans.SpanData

    def idle_pct(self) -> float | None:
        """Share of the window in which no operation ran on the card, in %."""
        if self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_intervals(self) -> list[tuple[int, int]]:
        """Union of the device operations' intervals, clipped to the window."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e in self.device
                       if e > lo and s < hi)
        merged: list[list[int]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def kernel_seconds(self, substring: str) -> tuple[float, int]:
        """Total device seconds and count of operations whose name holds
        `substring`, inside the window."""
        lo, hi = self.window
        hits = [(s, e) for n, s, e in self.device
                if substring in n and s >= lo and e <= hi]
        return sum(e - s for s, e in hits) * 1e-9, len(hits)

    def kernel_count(self, kernels_only: bool = False) -> int:
        """Device operations inside the window; with `kernels_only`, not
        counting copies and fills."""
        lo, hi = self.window
        return sum(1 for n, s, e in self.device if s >= lo and e <= hi
                   and not (kernels_only and n.startswith(("Memcpy", "Memset"))))

    def top_device_ops(self, k: int = 10) -> list[list]:
        lo, hi = self.window
        tot: dict[str, int] = {}
        for n, s, e in self.device:
            if s >= lo and e <= hi:
                tot[n] = tot.get(n, 0) + (e - s)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:120], v * 1e-9] for n, v in top]

    def idle_gaps(self, k: int = 10) -> list[list]:
        """Idle time of the card summed by what the host was doing: each
        gap between busy intervals is split among the host samples that
        fall in it (the last sample before it where none does)."""
        lo, hi = self.window
        busy = self.busy_intervals()
        gaps, prev = [], lo
        for s, e in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if hi > prev:
            gaps.append((prev, hi))
        samples = sorted(self.samples)
        times = [t for t, _ in samples]
        import bisect

        tot: dict[str, float] = {}
        for s, e in gaps:
            i, j = bisect.bisect_left(times, s), bisect.bisect_right(times, e)
            labels = [lab for _, lab in samples[i:j]]
            if not labels:
                labels = [samples[i - 1][1] if i > 0 else "?"]
            share = (e - s) * 1e-9 / len(labels)
            for lab in labels:
                tot[lab] = tot.get(lab, 0.0) + share
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:120], v] for n, v in top]


def _ns(ev, what: str) -> int:
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f"{what}_us")() * 1000)


def read_profile(prof, samples) -> TraceData:
    """Device operations, the harness's window span and, in the same pass,
    the program's spans and launch calls (`spans.add_host_event`) from a
    finished torch.profiler.profile."""
    from torch.autograd import DeviceType

    from sfmbench.lib.spans import add_host_event, span_data

    window = None
    device, spans, launches = [], [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CPU:
            name = ev.name()
            if name == HARNESS_SPAN:
                s = _ns(ev, "start")
                window = (s, s + int(_ns(ev, "duration")))
            else:
                add_host_event(ev, name, spans, launches)
            continue
        # The card's copy of a host annotation spans the work under it and
        # is no operation of its own.
        user = getattr(ev, "is_user_annotation", None)
        if ev.name() == HARNESS_SPAN or (user is not None and user()):
            continue
        s = _ns(ev, "start")
        device.append((ev.name(), s, s + int(_ns(ev, "duration"))))
    if window is None:
        raise RuntimeError(f"the profile holds no {HARNESS_SPAN!r} span")
    return TraceData(window, device, samples, span_data(window, spans, launches))
