"""Levenberg-Marquardt iterations per solve, as the solver counts them."""


def read(ctx):
    if not ctx.records:
        return None
    return sum(r["iterations"] for r in ctx.records) / len(ctx.records)
