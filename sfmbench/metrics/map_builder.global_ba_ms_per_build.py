"""Milliseconds of the MapBuilder's `global_ba` phase per build: the program's
`map_builder.global_ba` spans over the window's `map_builder.total` spans."""

from sfmbench.lib.spans import ms_per_build


def read(ctx):
    return None if ctx.spans is None else ms_per_build(ctx.spans, "map_builder.global_ba")
