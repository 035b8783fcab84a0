"""Percent of the host unpack spent in passes that overflowed their planes
and were redone wider: the program's own mp3tpu.unpack.pass spans with the
outcome overflow over its mp3tpu.unpack spans (pipeline.unpack_planes, every
pass included), totals over the window's calls (MP3TPU_SPANS=1;
utils.profiling.TOTALS after each call, cleared as the window opens). 0
where every chunk fits its first planes."""
from mp3bench.spans import instrument, window_totals  # noqa: F401


def read(ctx):
    got = window_totals(ctx)
    if not got or "mp3tpu.unpack" not in got[0]:
        return None
    t = got[0]
    whole = t["mp3tpu.unpack"]["total_s"]
    over = t.get("mp3tpu.unpack.pass/overflow", {"total_s": 0.0})["total_s"]
    return 100.0 * over / whole if whole > 0 else None
