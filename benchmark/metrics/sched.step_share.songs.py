"""Percent of the request's wall in the scheduler's steps: the program's
own mp3tpu.sched.pack spans (each _pack_dispatch: the refill, the
[S, win] host arrays, the H2D and the launches of decode_window_i16) and
mp3tpu.sched.route spans (each _materialize_route: the wait for the
step's PCM on the host and the sink pushes), over the root's wall, totals
over the window's calls (MP3TPU_SPANS=1; utils.profiling.TOTALS after each
call, cleared as the window opens)."""
from mp3bench.sched_spans import root_share
from mp3bench.spans import instrument  # noqa: F401


def read(ctx):
    return root_share(ctx, ("mp3tpu.sched.pack", "mp3tpu.sched.route"))
