"""Milliseconds of solve wall per conjugate-gradient step of the PCG
solver, over every solve of the window."""


def read(ctx):
    steps = sum(r["cg_steps"] for r in ctx.records)
    if not steps:
        return None
    return 1e3 * sum(r["wall_s"] for r in ctx.records) / steps
