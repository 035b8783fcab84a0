"""What the per-layer metrics that read the program's own spans
(mp3tpu_torch.utils.profiling) share: one snapshot of its TOTALS after each
call of the window, cleared in place as the window opens, under
MP3TPU_SPANS=1; and the device idle that no range of the program names. A
program without the spans (no TOTALS there) leaves those metrics out."""
from __future__ import annotations

import importlib

SPANS = "mp3tpu_torch.utils.profiling"
# the request roots say only that a call was running
ROOTS = ("mp3tpu.decode_files", "mp3tpu.encode_batch",
         "mp3tpu.transcode_batch")


def instrument(probe):
    if hasattr(importlib.import_module(SPANS), "TOTALS"):
        probe.env("MP3TPU_SPANS", "1")
        probe.snapshot("spans", SPANS, "TOTALS", reset=lambda d: d.clear())


def window_totals(ctx):
    """(TOTALS after the window's last call, the number of calls), or None
    where nothing was snapshot."""
    snaps = ctx.probe.snapshots.get("spans")
    return (snaps[-1], len(snaps)) if snaps else None


def idle_unnamed_share(ctx):
    """Percent of the traced window's device idle (window_s - busy_s) not in
    an idle_gaps entry named mp3tpu.*, the request roots counted as unnamed.
    idle_gaps keeps the ten largest entries, so the share is an upper
    bound."""
    tr = ctx.trace
    if not tr:
        return None
    idle = tr["window_s"] - tr["busy_s"]
    if idle <= 0:
        return None
    named = sum(s for n, s in tr["idle_gaps"]
                if n.startswith("mp3tpu.") and n not in ROOTS)
    return 100.0 * (idle - named) / idle
