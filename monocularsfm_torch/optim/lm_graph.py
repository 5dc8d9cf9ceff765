"""The dense path's LM loop on the card: one iteration as a CUDA graph.

A dense LM iteration of bundle adjustment (optim/ba.py: the trial step, the
accept test, the Ceres radius update and the stop tests) is some 350 small
kernels and one blocking read of the stop flag, and on bundles of a few
cameras the card waits on the host's launches.  `LMGraph` runs one
segment's iterations on the card without a process group:

* the state (K, R, t, X, radius, cost) lives in static buffers, and the
  loop body writes each next value into its buffer, so running the body
  again is the next iteration;
* the first iteration runs eagerly on a side stream (it sets up cuBLAS and
  cuSOLVER there); if it did not stop, the body is captured once on that
  stream and the graph replayed once an iteration, the stop flag read
  after each replay;
* the replayed kernels are the eager loop's, on the same values in the
  same order, so the iterates and the iteration count are the same bits.

The graphs of one device capture into one memory pool, one after another.

Spans: `ba.lm_capture` around the capture, and `ba.lm_replay` around each
replay with its `host_read.lm_exit`.
"""

from __future__ import annotations

import functools

import torch

from monocularsfm_torch.utils.spans import span


class _Turns:
    """What the LM graphs of one device share, one graph after another: the
    stream the loop runs and captures on (cuBLAS keeps a workspace for each
    stream it runs on) and one memory pool.  A graph's own pool would keep
    its memory after the graph is gone, until the allocator next empties
    its cache, so each solve would reserve more; in one pool the graphs
    hold one iteration's intermediates of the largest bundle.  A pool that
    no graph holds cannot be captured into again, so the last graph
    (`last`) lives on until the next capture has taken the pool over."""

    def __init__(self, index: int):
        with torch.cuda.device(index):
            self.stream = torch.cuda.Stream()
        self.pool = torch.cuda.graph_pool_handle()
        self.last = None


@functools.cache
def _turns(index: int) -> _Turns:
    return _Turns(index)


class LMGraph:
    """The LM iterations of one segment from `state`, (K, R, t, X, radius,
    cost), copied into static buffers (`self.state`).  `body(buffers)` runs
    one iteration on them, writes the next state into them and returns the
    stop flag, a bool tensor."""

    def __init__(self, body, state):
        self.body = body
        self.state = tuple(v.clone() for v in state)

    def step(self) -> torch.Tensor:
        """One iteration on the static buffers; returns the stop flag."""
        return self.body(self.state)

    def __call__(self, it: int, max_iterations: int) -> tuple[int, bool]:
        """`loop` on the card's side stream."""
        dev = self.state[0].device
        self.turns = _turns(dev.index)
        side = self.turns.stream
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            out = self.loop(it, max_iterations)
        torch.cuda.current_stream(dev).wait_stream(side)
        return out

    def loop(self, it: int, max_iterations: int) -> tuple[int, bool]:
        """Iterations from the count `it` until `max_iterations` or the
        stop: the first eagerly, the rest as replays of one capture, which
        a solve that stops at once never makes.  Returns (the iteration
        count, stopped)."""
        stop = self.step()
        with span("host_read.lm_exit"):
            done = bool(stop)
        it += 1
        if done or it >= max_iterations:
            return it, done
        with span("ba.lm_capture"):
            replay, stop = self._capture()
        while not done and it < max_iterations:
            with span("ba.lm_replay"):
                replay()
                with span("host_read.lm_exit"):
                    done = self._read(stop)
            it += 1
        return it, done

    def _capture(self):
        """The body captured once: (its replay, the stop flag it writes)."""
        self.host = torch.empty((), dtype=torch.bool, pin_memory=True)
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=self.turns.pool)
        try:
            stop = self.step()
        finally:
            graph.capture_end()
        self.turns.last = graph
        return graph.replay, stop

    def _read(self, stop: torch.Tensor) -> bool:
        """The stop flag after a replay, through a pinned buffer."""
        self.host.copy_(stop, non_blocking=True)
        torch.cuda.current_stream().synchronize()
        return bool(self.host)
