"""The rate loops' outer iterations, by granule class (counterpart of
tools/rate_loop_hist.py).

encode_batch of B copies of the bench's stereo signal (bench.signal, 10 s,
through the JAX tool's int16 rounding) at 128 kbps, joint stereo, under
MP3TPU_ITER_HIST=1 (the loops' per-row iteration counts folded into
encoder.vloop_device.ITER_STATS) and MP3TPU_ENCODE_PROFILE=1. One untimed
call of one stream first, then ITER_STATS is cleared and the B streams are
encoded once, timed; every granule-channel must be counted once. Prints
one JSON line with the JAX tool's keys and "device" and "card": per class
the histogram, its mean, percentiles, largest count and the share of rows
there (summarize), and in "prof" the encode's phase walls
(encoder.batch.LAST_PROFILE). The JAX tool's "prof" held vloop_device.PROF,
whose keys split the int8 wire packing's dispatch from its materialize; the
port leaves that packing out (the device encoder keeps its spectra on the
device), so the phases stand in its place.

    python -m mp3tpu_torch.tools.rate_loop_hist [--streams 64] [--seconds 10]
        [--device cuda]
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys

import numpy as np

from . import EXTRA_KEYS, check, environ, where

# the line's keys: the JAX tool's, and EXTRA_KEYS
KEYS = ("B", "stream_s", "wall_s", "x_aggregate", "classes", "prof") + EXTRA_KEYS
SR = 44100
BITRATE = 128


def q16(a: np.ndarray) -> np.ndarray:
    """The JAX tool's rounding: int16 by truncation of x * 32767, / 32768."""
    return (np.clip(a, -1, 1) * 32767).astype(np.int16).astype(np.float32) \
        / 32768.0


def summarize(hist) -> dict | None:
    """Rows, mean, p50 / p90 / p99, the largest count, the share of rows at
    it and the histogram of one class (the JAX tool's summarize)."""
    h = np.asarray(hist, np.int64)
    n = int(h.sum())
    if not n:
        return None
    idx = np.arange(len(h))
    cum = np.cumsum(h)
    pct = {p: int(idx[np.searchsorted(cum, n * p / 100.0)])
           for p in (50, 90, 99)}
    mx = int(idx[h > 0][-1])
    return {"rows": n, "mean": float((h * idx).sum() / n),
            "p50": pct[50], "p90": pct[90], "p99": pct[99],
            "max": mx, "at_max_frac": float(h[mx] / n), "hist": h.tolist()}


def measure(streams: int = 64, seconds: float = 10.0, device="cuda") -> dict:
    at = where(device)
    from ..bench import signal, timed
    from ..encoder import batch as eb
    from ..encoder import encode_batch
    from ..encoder import vloop_device as vd
    pcm = q16(signal(seconds))
    batch = [pcm] * streams
    with environ(MP3TPU_ITER_HIST="1", MP3TPU_ENCODE_PROFILE="1"), \
            contextlib.redirect_stdout(io.StringIO()):
        encode_batch(batch[:1], SR, bitrate=BITRATE, device=device)  # warm-up
        vd.ITER_STATS.clear()
        _, wall = timed(lambda: encode_batch(batch, SR, bitrate=BITRATE,
                                             device=device), device)
        classes = {k: summarize(v) for k, v in sorted(vd.ITER_STATS.items())}
        prof = dict(eb.LAST_PROFILE)
    # every granule-channel of every stream runs the loops once
    from ..encoder import ENCODER_DELAY, SPF
    G = -(-(len(pcm) + ENCODER_DELAY + 529) // SPF)
    G += G & 1
    rows = sum(c["rows"] for c in classes.values() if c is not None)
    check(rows == streams * G * pcm.shape[1],
          f"{rows} rows counted, {streams} x {G} granules x {pcm.shape[1]} "
          "channels encoded")
    return {"B": streams, "stream_s": seconds, "wall_s": wall,
            "x_aggregate": streams * seconds / wall, "classes": classes,
            "prof": prof, **at}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mp3tpu_torch.tools.rate_loop_hist",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(measure(args.streams, args.seconds, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
