"""What the per-layer metrics of the scheduler path share: a share of the
request root's wall, from the program's own spans (mp3bench.spans). The
root is mp3tpu.decode_files, or mp3tpu.decode_batch_streams where the
scheduler was called directly. A program without the scheduler's spans
(no mp3tpu.sched.load) leaves the metrics out."""
from __future__ import annotations

from .spans import window_totals

ROOTS = ("mp3tpu.decode_files", "mp3tpu.decode_batch_streams")


def sched_totals(ctx):
    """The window's TOTALS where the scheduler's spans are in them, else
    None."""
    got = window_totals(ctx)
    if not got or "mp3tpu.sched.load" not in got[0]:
        return None
    return got[0]


def root_share(ctx, names):
    """Percent of the root's wall that the spans `names` took, totals over
    the window's calls."""
    t = sched_totals(ctx)
    if t is None:
        return None
    root = next((t[r]["total_s"] for r in ROOTS if r in t), 0.0)
    if root <= 0:
        return None
    return 100.0 * sum(t[n]["total_s"] for n in names if n in t) / root
