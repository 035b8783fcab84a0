"""Mean outer-loop iterations a row of the rate loops over the window's
calls: encoder.vloop_device.ITER_STATS (MP3TPU_ITER_HIST=1), every kind of
row, cleared as the window opens."""
import numpy as np


def instrument(probe):
    probe.env("MP3TPU_ITER_HIST", "1")
    probe.snapshot("iter_stats", "mp3tpu_torch.encoder.vloop_device",
                   "ITER_STATS", reset=lambda d: d.clear())


def read(ctx):
    snaps = ctx.probe.snapshots.get("iter_stats")
    if not snaps:
        return None
    rows = iters = 0
    for h in snaps[-1].values():
        rows += int(h.sum())
        iters += int((h * np.arange(len(h))).sum())
    return iters / rows if rows else None
