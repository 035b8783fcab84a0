"""Percent of its roofline that csrc/fused_z.cu (C1-C5) reached in the
traced calls: its least time by peaks.fused_z_per_pair over its traced
device time."""
from mp3bench.readers import roofline


def read(ctx):
    return roofline(ctx, "fused_z")
