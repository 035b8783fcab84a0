"""Percent of the scheduler's slot-steps that held a live stream: the items
of the program's own mp3tpu.sched.pack spans (the slots with granules to
decode in each step) over those of its mp3tpu.sched.route spans (n_slots
a step: the slots every step decodes and copies back, padding included),
totals over the window's calls (MP3TPU_SPANS=1; utils.profiling.TOTALS
after each call). The rest is padding that the device decodes as the
shorter songs of a batch end."""
from mp3bench.sched_spans import sched_totals
from mp3bench.spans import instrument  # noqa: F401


def read(ctx):
    t = sched_totals(ctx)
    pack, route = (t.get(n) if t else None
                   for n in ("mp3tpu.sched.pack", "mp3tpu.sched.route"))
    if not pack or not route or route["items"] <= 0:
        return None
    return 100.0 * pack["items"] / route["items"]
