"""Milliseconds of the MapBuilder's `resume` phase (the COLMAP snapshot's
text parse and the restore of its poses and points): the mean of the
program's `map_builder.resume` spans, one a build."""

from sfmbench.lib.spans import mean_ms


def read(ctx):
    return None if ctx.spans is None else mean_ms(ctx.spans, "map_builder.resume")
