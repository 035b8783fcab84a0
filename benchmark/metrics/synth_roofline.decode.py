"""Percent of its roofline that csrc/synth.cu (C6-C7) reached in the
traced calls: its least time by peaks.synth_per_launch over its traced
device time."""
from mp3bench.readers import roofline


def read(ctx):
    return roofline(ctx, "synth")
