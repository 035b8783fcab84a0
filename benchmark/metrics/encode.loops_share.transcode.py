"""Percent of the call's wall in encode_batch's rate loops: the phases
passA and passB of encoder.batch.LAST_PROFILE (MP3TPU_ENCODE_PROFILE=1,
walls that end with the device drained) over the window's calls."""
from mp3bench.readers import profile_encode, profile_share


def instrument(probe):
    profile_encode(probe)


def read(ctx):
    return profile_share(ctx, ("passA", "passB"))
