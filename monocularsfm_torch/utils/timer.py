"""Phase wall-clock timers (reference src/Common/Timer.cpp equivalent).

Device work is asynchronous; callers that time device phases should pass
through jax.block_until_ready before pausing (SURVEY.md component #2 plan).
"""

from __future__ import annotations

import time


class Timer:
    def __init__(self, name: str = ""):
        self.name = name
        self.elapsed = 0.0
        self._start: float | None = None

    def start(self):
        self._start = time.perf_counter()
        return self

    def pause(self):
        if self._start is not None:
            self.elapsed += time.perf_counter() - self._start
            self._start = None

    resume = start

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.pause()

    def __str__(self):
        return f"{self.name:<24s}: {self.elapsed:9.3f} s"
