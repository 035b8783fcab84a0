"""Percent of the call's wall in encode_batch's host preparation and
staging: the phases host_prep (padding, the float64 block-type labels) and
stage (int16 staging, one H2D) of encoder.batch.LAST_PROFILE."""
from mp3bench.readers import profile_encode, profile_share


def instrument(probe):
    profile_encode(probe)


def read(ctx):
    return profile_share(ctx, ("host_prep", "stage"))
