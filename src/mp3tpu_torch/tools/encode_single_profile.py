"""The phases of one stream's encode, config 5's `encode` line (counterpart
of tools/encode_single_profile.py).

encode_pcm of the bench's 10 s signal (bench.signal, rounded to
int16-origin values as the JAX tool rounds it) at 128 kbps, as config 5
calls it, under MP3TPU_ENCODE_PROFILE=1: one untimed call, then `reps`
timed calls, each with the phase walls of encoder.batch.LAST_PROFILE that it
left (the phases of the batched device encoder at B=1, which encode_pcm
takes on a card for a stream of 128 granules or more; on the CPU it takes
the float64 host path, which has no phases: "route" says which ran). The
encoder's own profile print goes nowhere. Prints one JSON line with the JAX
tool's keys, "route", and "device" and "card".

    python -m mp3tpu_torch.tools.encode_single_profile [--reps 3]
        [--seconds 10] [--device cuda]
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys

import numpy as np

from . import EXTRA_KEYS, environ, where

# the line's keys: the JAX tool's, "route", and EXTRA_KEYS
KEYS = ("metric", "audio_s", "walls_s", "x_best", "phases_best", "mp3_bytes",
        "route") + EXTRA_KEYS
SR = 44100
BITRATE = 128


def measure(reps: int = 3, seconds: float = 10.0, device="cuda") -> dict:
    at = where(device)
    from ..bench import signal, timed
    from ..encoder import batch as eb
    from ..encoder import encode_pcm
    pcm = signal(seconds)
    pcmq = np.round(np.clip(pcm, -0.99, 0.99) * 32768.0) / 32768.0

    def one():
        before = eb.LAST_PROFILE
        out, wall = timed(lambda: encode_pcm(pcmq, SR, bitrate=BITRATE,
                                             device=device), device)
        # LAST_PROFILE is replaced only by a profiled encode_batch
        after = eb.LAST_PROFILE
        return out, wall, dict(after) if after is not before else {}

    with environ(MP3TPU_ENCODE_PROFILE="1"), \
            contextlib.redirect_stdout(io.StringIO()):
        one()                                   # warm-up
        runs = [one() for _ in range(reps)]
    walls = [w for _, w, _ in runs]
    best = min(range(reps), key=lambda i: walls[i])
    phases = runs[best][2]
    return {"metric": "encode_single_profile", "audio_s": seconds,
            "walls_s": walls, "x_best": seconds / min(walls),
            "phases_best": phases, "mp3_bytes": len(runs[best][0]),
            "route": "device_loops" if phases else "host", **at}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mp3tpu_torch.tools.encode_single_profile",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(measure(args.reps, args.seconds, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
