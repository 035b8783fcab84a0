"""Library indexing: segment_batch over N streams (counterpart of
tools/bench_segment.py).

segment_batch of N distinct byte copies of the bench's CBR clip
(tests/torch_clips/bench_cbr128.mp3): the device-resident batch decode with
each chunk's envelope reduced on the device (pipeline.segment_files), so
only the envelopes come to the host. One warm-up call of 2 streams, then
one timed call. Prints one JSON line with the JAX tool's keys and "device"
and "card".

    python -m mp3tpu_torch.tools.bench_segment [--streams 256] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import sys

from . import EXTRA_KEYS, check, where

# the line's keys: the JAX tool's, and EXTRA_KEYS
KEYS = ("metric", "value", "unit", "detail") + EXTRA_KEYS


def measure(n_streams: int = 256, device="cuda") -> dict:
    """The JSON line; raises when a stream has no segment or the batch's
    answer has the wrong length."""
    at = where(device)
    from ..api import decode, segment_batch
    from ..bench import fixture, timed
    data = fixture("cbr")
    pcm, sr = decode(data, device=device)
    seconds = len(pcm) / sr
    # distinct byte copies: nothing is cached by identity
    lib = [bytes(bytearray(data)) for _ in range(n_streams)]
    segment_batch(lib[:2], device=device)      # warm-up
    segs, wall = timed(lambda: segment_batch(lib, device=device), device)
    check(len(segs) == n_streams and all(len(s) >= 1 for s in segs),
          f"segment_batch of {n_streams} streams: {[len(s) for s in segs]}")
    audio = n_streams * seconds
    return {"metric": "segment_batch_x_realtime", "value": audio / wall,
            "unit": "x_realtime_per_chip",
            "detail": {"streams": n_streams, "audio_seconds": audio,
                       "wall_seconds": wall, "segments_per_file": len(segs[0]),
                       "first": [[float(v) for v in s] for s in segs[0][:3]]},
            **at}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mp3tpu_torch.tools.bench_segment",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--streams", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(measure(args.streams, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
