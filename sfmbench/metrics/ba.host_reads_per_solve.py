"""Blocking device-to-host reads per solve of bundle adjustment: the
program's `host_read.*` spans inside each `ba.solve`, averaged over the
window's solves."""

from sfmbench.lib.spans import host_reads_per_solve


def read(ctx):
    return None if ctx.spans is None else host_reads_per_solve(ctx.spans)
