"""The CG loop of bundle adjustment's PCG path: eager, and as a CUDA graph.

Both solve S x = rhs by block-Jacobi preconditioned CG (preconditioner
Uinv, the inverse of the cameras' damped blocks U_d), from x = 0, and stop
before step k + 1 where k reaches `pcg_iters` or ||res||^2 <= tol2; S x is
`ops.schur.schur_product` from the cached coupling blocks W, the points'
damped inverses Vi and U_d (optim/ba.py builds them once per LM iteration).
Both are called as `cg(W, Vi, U_d, Uinv, rhs, tol2, lead=None)` and return
(x, the CG steps k, the blocking reads made); `lead`, a span, is closed
where the loop starts.

* `cg_eager` launches one loop body at a time from the host and reads the
  stop test after each (one blocking read a step).  Under a process group
  the point-sharded part of S x is reduced by `reduce`.  Its spans: one
  `ba.cg_step` a body with the test after it, `host_read.cg_test` around
  each read.
* `CGGraph`, for the card without a group: the loop body written so that
  it runs a step or nothing (`_masked_body`), captured K times in one CUDA
  graph once a solve, and the graph replayed until the step count and the
  stop flag, read once a replay, say the loop is over.  Each body tests
  first, on the card, what the eager loop tests on the host; a body after
  the stop changes no iterate, and the Schur pair, gated by the same flag,
  returns at once.  The same kernels run on the same values in the same
  order as in the eager loop, so x and k are the same bits.  One
  `ba.cg_block` span a replay, with its `host_read.cg_test`.
"""

from __future__ import annotations

import torch

from monocularsfm_torch.ops import schur as schur_ops
from monocularsfm_torch.ops.schur import SchurPlan, _mv, schur_product
from monocularsfm_torch.utils.spans import span


def cg_start(Uinv: torch.Tensor, rhs: torch.Tensor):
    """The iterates (x, res, pvec, rz) before the first step."""
    x = torch.zeros_like(rhs)
    res = rhs
    z = _mv(Uinv, res)
    return x, res, z, (res * z).sum()


def cg_step(Sp, Uinv, x, res, pvec, rz):
    """One CG step from Sp = S pvec: the next (x, res, pvec, rz)."""
    alpha = rz / torch.clamp((pvec * Sp).sum(), min=1e-20)
    x = x + alpha * pvec
    res = res - alpha * Sp
    z = _mv(Uinv, res)
    rz_new = (res * z).sum()
    pvec = z + (rz_new / torch.clamp(rz, min=1e-20)) * pvec
    return x, res, pvec, rz_new


def cg_eager(plan: SchurPlan, pcg_iters: int, W, Vi, U_d, Uinv, rhs, tol2, *,
             reduce=None, lead: span | None = None):
    """The loop launched from the host, one stop test read a step.  With
    `reduce` (a group's all-reduce of one tensor) S x = U_d x - reduce(the
    point-sharded sum), as in distributed BA."""
    def S_mul(p):
        if reduce is None:
            return schur_product(W, Vi, p, plan, U_d)
        # U_d p is replicated: only the point-sharded term is reduced.
        return _mv(U_d, p) - reduce(schur_product(W, Vi, p, plan))

    reads = 0

    def continues(k, res):
        """The test before step k + 1: none at `pcg_iters`, else
        ||res||^2 > tol2, read on the host."""
        nonlocal reads
        if k >= pcg_iters:
            return False
        more = (res * res).sum() > tol2
        reads += 1
        with span("host_read.cg_test"):
            return bool(more)

    x, res, pvec, rz = cg_start(Uinv, rhs)
    k = 0
    more = continues(k, res)
    if lead is not None:
        lead.close()
    while more:
        with span("ba.cg_step"):
            x, res, pvec, rz = cg_step(S_mul(pvec), Uinv, x, res, pvec, rz)
            k += 1
            more = continues(k, res)
    return x, k, reads


def block_steps(pcg_iters: int) -> int:
    """CG bodies a graph replay: at most 32, and a whole number of replays
    reaches `pcg_iters` (100 -> 25, four replays)."""
    return -(-pcg_iters // -(-pcg_iters // 32))


class CGGraph:
    """The CG loop as a CUDA graph of `block_steps(pcg_iters)` masked
    bodies over static buffers, for one solve's `plan` on the card (no
    process group).  The first call warms one body up and captures the
    graph from its inputs' shapes and strides; every call copies its inputs
    in and replays the graph until the loop is over.  Later calls take
    inputs laid out as the first's."""

    def __init__(self, plan: SchurPlan, pcg_iters: int):
        self.plan, self.pcg_iters = plan, pcg_iters
        self.steps = block_steps(pcg_iters) if pcg_iters > 0 else 0
        self.graph = None

    def __call__(self, W, Vi, U_d, Uinv, rhs, tol2, *, lead: span | None = None):
        if self.pcg_iters <= 0:               # the eager loop tests nothing
            if lead is not None:
                lead.close()
            return torch.zeros_like(rhs), 0, 0
        inputs = (W, Vi, U_d, Uinv, tol2)
        if self.graph is None:
            with span("ba.cg_capture"):
                self._capture(inputs, rhs)
        self._load(inputs, rhs)
        if lead is not None:
            lead.close()
        stream = torch.cuda.current_stream(rhs.device)
        reads, more = 0, True
        while more:
            with span("ba.cg_block"):
                self.graph.replay()
                self.host.copy_(self.state, non_blocking=True)
                with span("host_read.cg_test"):
                    stream.synchronize()
                active, k = self.host.tolist()
            reads += 1
            more = bool(active) and k < self.pcg_iters
        schur_ops.count_passes(self.plan, k)
        return self.iterates[0].clone(), k, reads

    def _load(self, inputs, rhs) -> None:
        """Copy one LM iteration's inputs and the iterates before the first
        step into the static buffers; open the flag, zero the count."""
        for dst, src in zip(self.inputs, inputs):
            if dst.shape != src.shape or dst.stride() != src.stride():
                raise ValueError(
                    f"CGGraph: an input {tuple(src.shape)} {src.stride()} "
                    f"where the graph took {tuple(dst.shape)} {dst.stride()}")
            dst.copy_(src)
        for dst, src in zip(self.iterates, cg_start(self.inputs[3], rhs)):
            dst.copy_(src)
        self.state.copy_(self.start)

    def _masked_body(self) -> None:
        """One CG body on the static buffers: the stop test first, then a
        step where the flag stays open, nothing where it is shut."""
        W, Vi, U_d, Uinv, tol2 = self.inputs
        x, res, pvec, rz = self.iterates
        active, k = self.state[0], self.state[1]
        active.mul_((k < self.pcg_iters) & ((res * res).sum() > tol2))
        on = active.bool()
        Sp = schur_product(W, Vi, pvec, self.plan, U_d, active=active,
                           out=self.out, payload=self.payload)
        for old, new in zip(self.iterates, cg_step(Sp, Uinv, x, res, pvec, rz)):
            torch.where(on, new, old, out=old)
        k.add_(active)

    def _allocate(self, inputs, rhs) -> None:
        """The static buffers, laid out as this call's inputs and iterates
        (so each kernel meets the strides the eager loop gives it)."""
        dev = rhs.device
        self.inputs = tuple(torch.empty_like(t) for t in inputs)
        self.iterates = tuple(torch.empty_like(t)
                              for t in cg_start(inputs[3], rhs))
        self.state = torch.empty(2, dtype=torch.int32, device=dev)  # flag, k
        self.start = torch.tensor([1, 0], dtype=torch.int32, device=dev)
        self.out = torch.empty_like(rhs)
        self.payload = torch.empty((self.plan.cam_plan.ids.numel(), 8),
                                   dtype=torch.float32, device=dev)

    def _capture(self, inputs, rhs) -> None:
        dev = rhs.device
        self._allocate(inputs, rhs)
        self.host = torch.empty(2, dtype=torch.int32, pin_memory=True)
        # Warm up one body (the kernel's library and launch set-up) on a
        # side stream, then capture there; every call loads before it
        # replays.
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._load(inputs, rhs)
            self._masked_body()
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin()
            try:
                for _ in range(self.steps):
                    self._masked_body()
            finally:
                graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = graph
