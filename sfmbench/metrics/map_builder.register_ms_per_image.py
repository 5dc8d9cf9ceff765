"""Milliseconds of the MapBuilder's `register` phase (PnP and its RANSAC,
tried candidates included) per view that it registered: the program's
`map_builder.register` spans over the builds' registered views less their
initial pair."""

from sfmbench.lib.spans import total_ms


def read(ctx):
    total = None if ctx.spans is None else total_ms(ctx.spans, "map_builder.register")
    images = sum(max(r.get("registered", 0) - 2, 0) for r in ctx.records)
    if total is None or not images:
        return None
    return total / images
