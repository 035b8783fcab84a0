"""Milliseconds a call of trimming the host PCM and copying each stream
out of the chunk's pinned segments into an owned array: the program's own
mp3tpu.slice spans (pipeline._fast_chunk, around its _slice_parts loop),
their total over the window's calls (MP3TPU_SPANS=1;
utils.profiling.TOTALS after each call, cleared as the window opens)."""
from mp3bench.spans import instrument, window_totals  # noqa: F401


def read(ctx):
    got = window_totals(ctx)
    if not got or "mp3tpu.slice" not in got[0]:
        return None
    t, calls = got
    return 1e3 * t["mp3tpu.slice"]["total_s"] / calls
