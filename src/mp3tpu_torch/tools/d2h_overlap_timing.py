"""The segmented D2H overlap of decode_files, swept over decode.d2h_segments
(counterpart of tools/d2h_overlap_timing.py).

decode_files of 64 copies of the bench's CBR clip
(tests/torch_clips/bench_cbr128.mp3) to host PCM, the PCM's download
included, at decode.d2h_segments K in 1, 2, 4 and 8: the window loop in K
segments, each copied to the host on the copy stream while the next
decodes (K = 1: one copy at the end). Each K is warmed on 4 streams; the
timed runs go round-robin over the settings, `reps` rounds, so that a
drift of the host hits every K alike. The PCM must be bit-identical at
every K in every round, or the tool raises. The other decode settings stay
the caller's. Prints one JSON line per K with the JAX tool's keys and
"device" and "card".

    python -m mp3tpu_torch.tools.d2h_overlap_timing [--reps 3] [--streams 64]
        [--ks 1,2,4,8] [--device cuda]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np

from . import EXTRA_KEYS, check, where

KS = (1, 2, 4, 8)
# a line's keys: the JAX tool's, and EXTRA_KEYS
KEYS = ("d2h_segments", "audio_s", "walls_s", "best_x", "median_x") + EXTRA_KEYS


def measure(reps: int = 3, streams: int = 64, ks=KS, device="cuda") -> list:
    """One JSON line per K."""
    at = where(device)
    from .. import config
    from ..bench import fixture, timed
    from ..pipeline import decode_files
    data = fixture("cbr")
    batch = [data] * streams
    caller = config.get_active()

    def use(k):
        config.set_active(dataclasses.replace(
            caller, decode=dataclasses.replace(caller.decode, d2h_segments=k)))

    walls = {k: [] for k in ks}
    ref = audio = None
    try:
        for k in ks:                     # warm each K's shapes
            use(k)
            decode_files([data] * 4, device=device)
        for _ in range(reps):
            for k in ks:
                use(k)
                out, wall = timed(lambda: decode_files(batch, device=device),
                                  device)
                walls[k].append(wall)
                if ref is None:
                    ref, audio = out, sum(len(p) / s for p, s in out)
                check(all(np.array_equal(a, b) and r == s
                          for (a, r), (b, s) in zip(ref, out)),
                      f"d2h_segments={k}: the PCM differs from "
                      f"d2h_segments={ks[0]}'s")
    finally:
        config.set_active(caller)
    return [{"d2h_segments": k, "audio_s": audio, "walls_s": walls[k],
             "best_x": audio / min(walls[k]),
             "median_x": audio / sorted(walls[k])[len(walls[k]) // 2], **at}
            for k in ks]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mp3tpu_torch.tools.d2h_overlap_timing",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--ks", default=",".join(map(str, KS)),
                    help="the d2h_segments settings, comma-separated")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ks = tuple(int(k) for k in args.ks.split(","))
    for line in measure(args.reps, args.streams, ks, args.device):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
