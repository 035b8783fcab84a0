"""Percent of the traced window in which the device ran nothing (no
kernel, copy or memset): the host's share of the cell's wall."""
from mp3bench.readers import idle_share


def read(ctx):
    return idle_share(ctx)
