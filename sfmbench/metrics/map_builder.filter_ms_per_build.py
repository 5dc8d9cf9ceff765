"""Milliseconds of the MapBuilder's `filter` phase per build: the program's
`map_builder.filter` spans over the window's `map_builder.total` spans."""

from sfmbench.lib.spans import ms_per_build


def read(ctx):
    return None if ctx.spans is None else ms_per_build(ctx.spans, "map_builder.filter")
