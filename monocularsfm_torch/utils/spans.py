"""Named spans of the port, as user annotations of torch.profiler.

A span marks a stretch of host work (a phase of bundle adjustment, a
blocking read of a device value) in whatever torch.profiler trace is being
recorded: an operator's own `torch.profiler.profile`, the MapBuilder's
`profile_dir` trace or a benchmark's window.  It lies on the profiler's
clock, beside the card's kernels, and it is one of the trace's user
annotations, like `torch.profiler.record_function`'s.

With no profiler running a span costs one flag check; it is opened only
while one runs.  A span never waits for the device.

Names: `<layer>.<phase>` for a phase (`ba.cg_step`), and
`host_read.<site>` for a leaf span around one blocking device-to-host read,
so that a trace can count the reads and find the card's idle time that
follows each.
"""

from __future__ import annotations

from torch._C._autograd import _profiler_enabled
from torch._C._autograd import _record_function_with_args_enter as _enter
from torch._C._autograd import _record_function_with_args_exit as _exit


class span:
    """The span `name` from its creation to `close()`, or to the end of the
    `with` block it opens.  (`torch.profiler.record_function` costs about
    13 microseconds even with no profiler running, and several times this
    class's entry under one.)"""

    __slots__ = ("_handle",)

    def __init__(self, name: str):
        self._handle = _enter(name) if _profiler_enabled() else None

    def close(self, *exc) -> None:
        if self._handle is not None:
            _exit(self._handle)
            self._handle = None

    def __enter__(self) -> "span":
        return self

    __exit__ = close
