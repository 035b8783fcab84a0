"""Percent of the call's wall in transcode_batch's decode half: the
program's own mp3tpu.decode_files span (the scan, the unpack, the staging,
the window loop and the DecodedBatch's records) over the call walls, totals
over the window's calls (MP3TPU_SPANS=1; utils.profiling.TOTALS after each
call, cleared as the window opens)."""
from mp3bench.spans import instrument, window_totals  # noqa: F401


def read(ctx):
    got = window_totals(ctx)
    if not got or not ctx.calls or "mp3tpu.decode_files" not in got[0]:
        return None
    t, calls = got
    return (100.0 * t["mp3tpu.decode_files"]["total_s"]
            / sum(ctx.calls[:calls]))
