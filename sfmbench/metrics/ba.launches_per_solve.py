"""Kernel launches per solve of bundle adjustment: the runtime's launch
calls (`SpanData.launches`) that start inside each `ba.solve` span,
averaged over the window's solves.  A replayed CUDA graph is one
`cudaGraphLaunch` and counts no launch; its capture counts the launches
it records."""

import bisect


def read(ctx):
    if ctx.spans is None:
        return None
    solves = ctx.spans.named("ba.solve")
    if not solves:
        return None
    t = ctx.spans.launches
    n = sum(bisect.bisect_left(t, e) - bisect.bisect_left(t, s) for s, e in solves)
    return n / len(solves)
