"""The port's measurement tools: the counterparts of the repository's tools/
that drive mp3tpu and measure it on a chip, which stay the JAX package's.

    python -m mp3tpu_torch.tools.device_huffman_spike   # the Huffman chain on the card
    python -m mp3tpu_torch.tools.bench_repeat           # repeat listening, the group cache
    python -m mp3tpu_torch.tools.bench_segment          # segment_batch of 256 streams
    python -m mp3tpu_torch.tools.d2h_overlap_timing     # decode.d2h_segments 1 / 2 / 4 / 8
    python -m mp3tpu_torch.tools.encode_single_profile  # the phases of one encode
    python -m mp3tpu_torch.tools.rate_loop_hist         # the rate loops' iterations

Each has a main(argv) and --device (cuda by default: the card, and an error
where there is none; cpu runs the port on the CPU, as the tests do), reads
its inputs only from the checkout's tests/torch_clips/ (through
mp3tpu_torch.bench.fixture) and bench.signal(), checks what its JAX
counterpart asserts, and prints one JSON line per measurement with the JAX
tool's keys, plus "device" and "card" (the card's name and power limit, or
None on the CPU). No runtime module of the port imports this package.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from ..bench import CheckFailed, device_facts  # noqa: F401  (CheckFailed: what check raises)
from ..bench import _check as check

# the keys every tool's line adds to its JAX counterpart's
EXTRA_KEYS = ("device", "card")


def where(device) -> dict:
    """The "device" and "card" of a line. Raises for a CUDA device on a host
    without one (bench.device_facts): no tool falls back to the CPU."""
    facts = device_facts(device)
    return {"device": facts["device"], "card": facts["card"]}


@contextlib.contextmanager
def environ(**values):
    """The environment variables `values` set inside the block, restored
    after it."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def cuda_ms(fn, reps: int = 7, inner: int = 10) -> float:
    """Milliseconds per call of fn() on the card: the median over `reps`
    timings (CUDA events) of `inner` back-to-back calls each, after one
    warm-up; each timing starts behind a 20 ms spin of the card, so that the
    events time the device's work and not the host's launches."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40_000_000)  # cycles: about 20 ms at 1.98 GHz
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))
