"""Percent of the rate loops' bisected rows that went through the hand-written
kernel (csrc/rate_bisect.cu) in transcode_batch: the items (rows) of the
program's mp3tpu.encode.bisect spans with the outcome kernel over those of
both outcomes (kernel, plain), totals over the window's calls
(MP3TPU_SPANS=1; utils.profiling.TOTALS after each call, cleared as the
window opens). None where the program has no such span."""
from mp3bench.spans import instrument, window_totals  # noqa: F401


def read(ctx):
    got = window_totals(ctx)
    if not got:
        return None
    rows = {o: got[0].get(f"mp3tpu.encode.bisect/{o}", {}).get("items", 0)
            for o in ("kernel", "plain")}
    total = rows["kernel"] + rows["plain"]
    return 100.0 * rows["kernel"] / total if total else None
