"""Milliseconds a call that the host waits for the PCM's copies to reach
it: the program's own mp3tpu.d2h.wait spans (pipeline._fast_chunk, one
around each HostCopy's numpy()), their total over the window's calls
(MP3TPU_SPANS=1; utils.profiling.TOTALS after each call, cleared as the
window opens)."""
from mp3bench.spans import instrument, window_totals  # noqa: F401


def read(ctx):
    got = window_totals(ctx)
    if not got or "mp3tpu.d2h.wait" not in got[0]:
        return None
    t, calls = got
    return 1e3 * t["mp3tpu.d2h.wait"]["total_s"] / calls
