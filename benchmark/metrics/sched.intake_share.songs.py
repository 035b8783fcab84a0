"""Percent of the request's wall spent taking the songs in, before the
scheduler's first step: the container scan and granule probe of the fast
path's triage (mp3tpu.scan, mp3tpu.probe_granules), the scheduler's second
scan (mp3tpu.sched.load, each load_source) and its whole-stream unpack
(mp3tpu.sched.unpack, each SymbolSource.whole()), over the root's wall;
the program's own spans, totals over the window's calls (MP3TPU_SPANS=1;
utils.profiling.TOTALS after each call, cleared as the window opens)."""
from mp3bench.sched_spans import root_share
from mp3bench.spans import instrument  # noqa: F401

INTAKE = ("mp3tpu.scan", "mp3tpu.probe_granules", "mp3tpu.sched.load",
          "mp3tpu.sched.unpack")


def read(ctx):
    return root_share(ctx, INTAKE)
