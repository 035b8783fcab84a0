"""Arithmetic that more than one per-layer metric's reader shares. A
reader that finds nothing to read returns None, and the metric is left out
of the result line; a share of a roofline is never made 0 or capped."""
from __future__ import annotations

from . import peaks

PIPELINE = "mp3tpu_torch.pipeline"


def idle_share(ctx):
    """Percent of the traced window in which no kernel, copy or memset ran
    on the device."""
    tr = ctx.trace
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def _decode_shape(ctx) -> tuple:
    d = ctx.program.decode
    return d.batch_chunk_streams, d.window_granules


def roofline(ctx, kernel: str):
    """Percent of the least time (peaks.py) that the traced launches of
    `kernel` ("fused_z" or "synth") took, summed over every launch. Every
    launch on the decode fast path covers [S, win] granules: S the chunk's
    streams (decode.batch_chunk_streams), win its window."""
    tr = ctx.trace
    if not tr:
        return None
    S, win = _decode_shape(ctx)
    least = took = 0.0
    for name, (n, secs) in tr["kernels"].items():
        if kernel == "fused_z":
            per = peaks.fused_z_per_pair(name)
            if per is None:
                continue
            least += n * peaks.least_seconds(per[0] * S * win, per[1] * S * win)
        elif "synth_kernel" in name:
            least += n * peaks.least_seconds(*peaks.synth_per_launch(S, win))
        else:
            continue
        took += secs
    return 100.0 * least / took if took > 0 else None


def profile_share(ctx, phases):
    """Percent of the window's call walls that encode_batch's phase walls
    (MP3TPU_ENCODE_PROFILE=1, encoder.batch.LAST_PROFILE after each call)
    `phases` take."""
    snaps = ctx.probe.snapshots.get("encode_profile")
    if not snaps or not ctx.calls:
        return None
    spent = sum(s.get(p, 0.0) for s in snaps for p in phases)
    return 100.0 * spent / sum(ctx.calls[:len(snaps)])


def profile_encode(probe) -> None:
    probe.env("MP3TPU_ENCODE_PROFILE", "1")
    probe.snapshot("encode_profile", "mp3tpu_torch.encoder.batch",
                   "LAST_PROFILE")
