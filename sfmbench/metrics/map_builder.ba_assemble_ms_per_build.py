"""Milliseconds of the MapBuilder's `ba_assemble` phase (each local and
global bundle laid out from the map) per build: the program's
`map_builder.ba_assemble` spans over the window's `map_builder.total`
spans."""

from sfmbench.lib.spans import ms_per_build


def read(ctx):
    return (None if ctx.spans is None
            else ms_per_build(ctx.spans, "map_builder.ba_assemble"))
