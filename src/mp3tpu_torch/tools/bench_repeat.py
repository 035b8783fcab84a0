"""Repeat listening: the Player's group cache, measured (counterpart of
tools/bench_repeat.py).

The reference's core usage replays one sentence N times. The port's Player
keeps the decoded group's device PCM in a two-entry cache
(player/engine.py), so a repeat pass decodes nothing. This puts a number on
it in config 4's conditions (a Player with gain and the gapless trim, on
the bench's CBR clip, tests/torch_clips/bench_cbr128.mp3): the wall of
loop(1.0, 6.0, times=N) against N x the wall of times=1, and the granules
decoded by each, which show that the cache, not a warm-up, is what the
clock sees. One untimed session first. Prints one JSON line with the JAX
tool's keys (detail keys named by N) and "device" and "card".

    python -m mp3tpu_torch.tools.bench_repeat [--times 5] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import sys

from . import EXTRA_KEYS, check, where

# the line's keys: the JAX tool's, and EXTRA_KEYS
KEYS = ("metric", "value", "unit", "detail") + EXTRA_KEYS
SEGMENT = (1.0, 6.0)   # seconds: the loop's [a, b)
GAIN_DB = -3.0


def _session(data: bytes, times: int, device):
    """(wall s, granules decoded, samples pushed) of one Player's
    loop(*SEGMENT, times)."""
    from ..bench import timed
    from ..player import Player
    p = Player(data, gain_db=GAIN_DB, device=device)
    _, wall = timed(lambda: p.loop(*SEGMENT, times=times), device)
    return wall, p.metrics.granules_decoded, len(p.sink.pcm)


def measure(times: int = 5, device="cuda") -> dict:
    """The JSON line; raises when a repeat pass decodes granules or the PCM
    is not `times` passes long."""
    if times < 2:
        raise ValueError(f"times {times}: a repeat needs at least 2")
    at = where(device)
    from ..bench import fixture
    data = fixture("cbr")
    a, b = SEGMENT
    _session(data, 1, device)            # warm-up: the session's shapes
    t1, g1, n1 = _session(data, 1, device)
    tn, gn, nn = _session(data, times, device)
    check(nn == times * n1, f"{nn} samples for {times} passes of {n1}")
    # the cache claim: the repeats decode nothing beyond the first pass
    check(gn == g1, f"{gn} granules decoded for {times} passes, {g1} for one")
    return {"metric": "repeat_session_speedup", "value": times * t1 / tn,
            "unit": f"x_vs_{times}x_uncached",
            "detail": {"segment_s": b - a, "times": times,
                       "wall_times1_s": t1, f"wall_times{times}_s": tn,
                       "granules_decoded_times1": g1,
                       f"granules_decoded_times{times}": gn,
                       "repeat_pass_s": (tn - t1) / (times - 1)},
            **at}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mp3tpu_torch.tools.bench_repeat",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--times", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(measure(args.times, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
