"""Mean length of a conjugate-gradient step of the PCG solver, in ms: the
program's `ba.cg_step` spans (one CG loop body and its stop test)."""

from sfmbench.lib.spans import mean_ms


def read(ctx):
    return None if ctx.spans is None else mean_ms(ctx.spans, "ba.cg_step")
