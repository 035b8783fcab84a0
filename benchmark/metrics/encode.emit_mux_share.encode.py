"""Percent of the call's wall in encode_batch's emission and mux: the
program's own mp3tpu.encode.emit and mp3tpu.encode.mux spans (host walls,
no sync of their own) over the call walls, totals over the window's calls
(MP3TPU_SPANS=1; utils.profiling.TOTALS after each call, cleared as the
window opens)."""
from mp3bench.spans import instrument, window_totals  # noqa: F401

PHASES = ("mp3tpu.encode.emit", "mp3tpu.encode.mux")


def read(ctx):
    got = window_totals(ctx)
    if not got or not ctx.calls or not any(p in got[0] for p in PHASES):
        return None
    t, calls = got
    spent = sum(t[p]["total_s"] for p in PHASES if p in t)
    return 100.0 * spent / sum(ctx.calls[:calls])
