"""Metrics / observability (SURVEY.md F3, §5.5).

Counters and gauges for the decode/play pipelines, and the wall-clock
books `span()` adds to (host_seconds, device_seconds).

The fault-counter family (frames_ok/frames_error/granules_muted/
resyncs — SURVEY.md §5.3 "error counters increment") is fed from the
per-granule error taxonomy every unpack emits (bitstream.unpack ERR_*
flags) via count_symbol_errors(); every decode path (decode_file,
the batch fast path, the scheduler, the player) feeds both its local
Metrics and the process-wide GLOBAL instance, so an operator tailing
GLOBAL.log_line() sees corruption the moment any path decodes it.

Copy of mp3tpu.metrics, kept in the port so that it imports nothing of
the JAX package; the code is the same less realtime_factor and the unused
_spans field. The program's spans and counters for its per-layer metrics
are utils/profiling.py's, not these books.
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass

import numpy as np

# flag values mirrored from bitstream.unpack (import would be circular
# at module load; tests/test_faults.py pins the equality)
_ERR_MUTED_MASK = 1 | 8  # ERR_RESERVOIR | ERR_BAD_DATA: spectrum zeroed


@dataclass
class Metrics:
    frames_ok: int = 0
    frames_error: int = 0
    resyncs: int = 0
    granules_decoded: int = 0
    granules_muted: int = 0
    samples_out: int = 0
    underruns: int = 0
    overruns: int = 0
    seeks: int = 0
    streams_active: int = 0
    streams_finished: int = 0
    host_seconds: float = 0.0
    device_seconds: float = 0.0

    def span(self, name: str):
        return _Span(self, name)

    def count_symbol_errors(self, errors, granules_per_frame: int = 2) -> None:
        """Feed one unpacked granule range's fault taxonomy (the int16
        ERR_* flag array of SymbolTensors.errors) into the frame/granule
        counter family: frames_error counts frames carrying any flagged
        granule, frames_ok the rest, granules_muted the granules whose
        spectrum was zeroed (reservoir underflow / bad data — the §5.3
        mute policy)."""
        e = np.asarray(errors, np.int64).ravel()
        if e.size == 0:
            return
        self.granules_muted += int(((e & _ERR_MUTED_MASK) != 0).sum())
        ngr = max(1, granules_per_frame)
        pad = (-len(e)) % ngr
        if pad:  # partial trailing frame in a window slice
            e = np.concatenate([e, np.zeros(pad, np.int64)])
        bad = (e.reshape(-1, ngr) != 0).any(axis=1)
        self.frames_error += int(bad.sum())
        self.frames_ok += int((~bad).sum())

    def merge(self, other: "Metrics") -> "Metrics":
        """Accumulate another Metrics into this one (multi-track
        sessions: the queue's totals are the sum over its players).
        Extra span-derived `*_seconds` attrs are summed too."""
        for k, v in other.__dict__.items():
            if k.startswith("_") or not isinstance(v, (int, float)):
                continue
            setattr(self, k, getattr(self, k, 0) + v)
        return self

    def to_dict(self) -> dict:
        return {k: v for k, v in self.__dict__.items() if not k.startswith("_")}

    def log_line(self) -> str:
        return json.dumps({"mp3tpu_metrics": self.to_dict()})


# process-wide counters: the operator-facing aggregate every decode
# path feeds alongside its local Metrics (mp3tpu.metrics() returns it).
# GLOBAL is shared by every concurrently-running decoder (a Player and
# a StreamScheduler on separate threads is a supported pattern), so its
# read-modify-write updates go through _GLOBAL_LOCK; path-local Metrics
# have a single owner and stay lock-free.
GLOBAL = Metrics()
_GLOBAL_LOCK = threading.Lock()


def record_symbol_errors(errors, granules_per_frame: int,
                         *locals_: Metrics) -> None:
    """Count one granule range's error flags into GLOBAL plus any
    path-local Metrics instances (the single feed point call sites use,
    so local and global books always agree)."""
    tmp = Metrics()
    tmp.count_symbol_errors(errors, granules_per_frame)
    with _GLOBAL_LOCK:
        GLOBAL.frames_ok += tmp.frames_ok
        GLOBAL.frames_error += tmp.frames_error
        GLOBAL.granules_muted += tmp.granules_muted
    for m in locals_:
        m.frames_ok += tmp.frames_ok
        m.frames_error += tmp.frames_error
        m.granules_muted += tmp.granules_muted


def record_resyncs(n: int, *locals_: Metrics) -> None:
    """Count scanner resync events (container.frames.FrameIndex.resyncs)
    into GLOBAL plus any path-local Metrics."""
    if n:
        with _GLOBAL_LOCK:
            GLOBAL.resyncs += n
        for m in locals_:
            m.resyncs += n


def record_underruns(n: int, *locals_: Metrics) -> None:
    """Aggregate sink-level starvation events into GLOBAL plus any
    path-local Metrics (§5.5; sinks count locally via take_underruns)."""
    if n:
        with _GLOBAL_LOCK:
            GLOBAL.underruns += n
        for m in locals_:
            m.underruns += n


class _Span:
    def __init__(self, m: Metrics, name: str):
        self.m, self.name = m, name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        key = f"{self.name}_seconds"
        setattr(self.m, key, getattr(self.m, key, 0.0) + dt)
        return False
