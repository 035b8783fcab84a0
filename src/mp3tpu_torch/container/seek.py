"""Seek table: time -> frame mapping with bit-reservoir pre-roll
(SURVEY.md A6, §7.5 hard part 3).

Exact-sample seek = land on an earlier frame, pre-roll enough frames to
refill the bit reservoir (main_data_begin reaches back <= 511 bytes) and
the decoder's 529-sample filterbank delay, then discard the pre-rolled
samples. PREROLL_FRAMES=3 guarantees >=511 bytes of main data at any
conformant bitrate and rebuilds overlap/FIFO state to float accuracy.

Copy of mp3tpu.container.seek, kept in the port so that it imports nothing of
the JAX package; the code is the same.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .frames import FrameIndex
from .xing import StreamInfo

DECODER_DELAY = 529
PREROLL_FRAMES = 3


@dataclass
class SeekPoint:
    frame: int           # first frame to decode (includes pre-roll)
    skip_samples: int    # samples to drop from that frame's output
    target_frame: int    # frame containing the requested sample


class SeekTable:
    """Maps time/sample positions onto frame indices."""

    def __init__(self, index: FrameIndex, info: StreamInfo | None = None):
        self.index = index
        self.info = info
        counts = np.asarray([h.samples for h in index.headers], np.int64)
        self.frame_starts = np.concatenate([[0], np.cumsum(counts)])
        self.sample_rate = index.sample_rate

    @property
    def total_samples(self) -> int:
        return int(self.frame_starts[-1])

    @property
    def duration(self) -> float:
        return self.total_samples / self.sample_rate

    def sample_to_seekpoint(self, sample: int) -> SeekPoint:
        sample = max(0, min(sample, self.total_samples - 1))
        target = int(np.searchsorted(self.frame_starts, sample, "right") - 1)
        first = max(0, target - PREROLL_FRAMES)
        skip = sample - int(self.frame_starts[first])
        return SeekPoint(frame=first, skip_samples=skip, target_frame=target)

    def time_to_seekpoint(self, seconds: float) -> SeekPoint:
        return self.sample_to_seekpoint(int(round(seconds * self.sample_rate)))

    def byte_offset_estimate(self, seconds: float) -> int:
        """Coarse byte estimate via the Xing TOC when present, else CBR
        arithmetic — used to bound scanning when a full FrameIndex is not
        available (e.g. network streams)."""
        frac = min(max(seconds / max(self.duration, 1e-9), 0.0), 0.999)
        if self.info is not None and self.info.toc is not None and self.info.n_bytes:
            i = int(frac * 100)
            lo = self.info.toc[i] / 256.0
            hi = (self.info.toc[i + 1] / 256.0) if i < 99 else 1.0
            f = lo + (hi - lo) * (frac * 100 - i)
            return int(f * self.info.n_bytes)
        total_bytes = int(self.index.offsets[-1]) + self.index.headers[-1].frame_bytes
        return int(frac * total_bytes)
