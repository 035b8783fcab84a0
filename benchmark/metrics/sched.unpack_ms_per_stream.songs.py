"""Milliseconds of the scheduler's whole-stream unpack a song: the
program's own mp3tpu.sched.unpack spans (each SymbolSource.whole() in
decode_batch_streams, the C++ window unpacker over the whole stream on
one thread), their total over their count, over the window's calls
(MP3TPU_SPANS=1; utils.profiling.TOTALS after each call)."""
from mp3bench.sched_spans import sched_totals
from mp3bench.spans import instrument  # noqa: F401


def read(ctx):
    t = sched_totals(ctx)
    u = t and t.get("mp3tpu.sched.unpack")
    return 1e3 * u["total_s"] / u["count"] if u and u["count"] else None
