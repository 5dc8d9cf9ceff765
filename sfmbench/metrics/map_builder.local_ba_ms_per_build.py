"""Milliseconds of the MapBuilder's `local_ba` phase (each local bundle
laid out, solved and written back) per build: the program's
`map_builder.local_ba` spans over the window's `map_builder.total`
spans."""

from sfmbench.lib.spans import ms_per_build


def read(ctx):
    return None if ctx.spans is None else ms_per_build(ctx.spans, "map_builder.local_ba")
