"""Percent of the traced window's device idle that no range of the
program's own names (mp3bench.spans.idle_unnamed_share): what is left to
the harness's wrappers, the request roots and the stretches between
ranges."""
from mp3bench.spans import idle_unnamed_share


def read(ctx):
    return idle_unnamed_share(ctx)
