"""encode_batch of seeded int16-origin stereo PCM (mp3bench/signals.py) at
the mix's bitrate: float PCM in, MP3 bytes out.

Every batch holds each signal kind equally often. A stream is its kind's
signal of the run (one per kind, from the seed) turned by a seeded
circular shift, with a seeded gain and channel order: the kinds, and so
the work of the rate loops, do not change with the seed; the order and
the content do.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import compose, signals
from ..checks import encoded_numbers


@dataclass
class Batch:
    inputs: list        # float64 [n, 2] PCM, one a stream
    sample_rate: int
    bitrate: int


@dataclass
class Work:
    batches: list
    sample_rate: int


def prepare(cell, seed: int) -> Work:
    t = cell.traffic
    sr = cell.config["format"]["sample_rate"]
    kinds = t["signal_kinds"]
    pool = {k: signals.make(k, t["stream_seconds"], int(seed) % (1 << 32), sr)
            for k in kinds}
    n = t["streams_per_call"]
    if n % len(kinds):
        raise ValueError(f"{n} streams do not hold {len(kinds)} kinds equally")
    batches = []
    for b in range(t["distinct_batches"]):
        g = compose.rng(seed, 2, b)
        order = g.permutation(np.repeat(np.arange(len(kinds)), n // len(kinds)))
        pcms = []
        for i in order:
            base = pool[kinds[i]]
            x = np.roll(base, int(g.integers(len(base))), axis=0)
            x = signals.q16(x * g.uniform(0.7, 1.0))
            pcms.append(np.ascontiguousarray(x[:, ::-1] if g.random() < 0.5 else x))
        batches.append(Batch(inputs=pcms, sample_rate=sr,
                             bitrate=t["bitrate_kbps"]))
    return Work(batches=batches, sample_rate=sr)


def call(m, batch: Batch, device):
    return m.encode_batch(batch.inputs, batch.sample_rate,
                          bitrate=batch.bitrate, device=device)


def completed(outputs, batch: Batch) -> tuple:
    audio, failed = 0.0, len(batch.inputs) - len(outputs)
    for x, out in zip(batch.inputs, outputs):
        if out:
            audio += len(x) / batch.sample_rate
        else:
            failed += 1
    return audio, failed


def keep(outputs, batch: Batch, k: int):
    return outputs[k] if k < len(outputs) else None


def check(kept, work: Work, cell) -> dict:
    items = [(data, work.batches[b].inputs[k]) for b, k, data in kept]
    return encoded_numbers(items, cell.config["format"],
                           cell.traffic["bitrate_kbps"])


def control(kept, work: Work, cell, m, device) -> list:
    """The program at the next lower bitrate: the step that fewer bits
    would tempt."""
    lower = lower_bitrate(cell.traffic["bitrate_kbps"])
    out = []
    for b, k, _data in kept:
        x = work.batches[b].inputs[k]
        out.append((b, k, m.encode_batch([x], work.sample_rate,
                                         bitrate=lower, device=device)[0]))
    return out


def lower_bitrate(kbps: int) -> int:
    """The MPEG-1 Layer III bitrate one step below kbps."""
    rates = (32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320)
    return rates[rates.index(kbps) - 1]
