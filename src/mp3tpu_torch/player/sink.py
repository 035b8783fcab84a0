"""Audio sinks + PCM ring buffer (SURVEY.md D7).

(Counterpart of mp3tpu.player.sink, copied as it is: mp3tpu.player imports JAX on
import, which the port never does.)

WAV/raw file writers are always available; a realtime device sink
(ALSA/PortAudio) is a feature-flagged stub here because no audio stack
exists on TPU hosts — the engine's contract is the sink interface, and
the ring buffer provides the underrun accounting (F3) that a realtime
sink would consume.
"""
from __future__ import annotations

import struct
import threading

import numpy as np


class Sink:
    """Abstract PCM sink: int16 [n, ch] chunks.

    `underruns` is the sink's own starvation count (nonzero only for
    sinks with realtime consumption semantics, e.g. a ring a consumer
    drains); producers aggregate it into Metrics.underruns via
    take_underruns() (SURVEY.md §5.5)."""

    underruns = 0

    def push(self, pcm: np.ndarray) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


def take_underruns(sink) -> int:
    """Delta of sink-reported underruns since the last take (0 for
    sinks without underrun accounting). The producer that routes PCM
    into the sink calls this after each push and adds the delta to its
    Metrics — sink-level counts aggregate instead of being stranded."""
    u = int(getattr(sink, "underruns", 0) or 0)
    seen = getattr(sink, "_underruns_taken", 0)
    if u <= seen:
        return 0
    sink._underruns_taken = u
    return u - seen


class WavFileSink(Sink):
    """Streaming RIFF/WAVE writer; header patched on close."""

    def __init__(self, path: str, sample_rate: int, channels: int):
        self.f = open(path, "wb")
        self.sample_rate = sample_rate
        self.channels = channels
        self.data_bytes = 0
        self._write_header()

    def _write_header(self):
        ch, sr = self.channels, self.sample_rate
        self.f.write(b"RIFF" + b"\x00" * 4 + b"WAVEfmt ")
        self.f.write(struct.pack("<IHHIIHH", 16, 1, ch, sr,
                                 sr * ch * 2, ch * 2, 16))
        self.f.write(b"data" + b"\x00" * 4)

    def push(self, pcm: np.ndarray) -> None:
        b = np.ascontiguousarray(pcm.astype("<i2")).tobytes()
        self.f.write(b)
        self.data_bytes += len(b)

    def close(self) -> None:
        self.f.seek(4)
        self.f.write(struct.pack("<I", 36 + self.data_bytes))
        self.f.seek(40)
        self.f.write(struct.pack("<I", self.data_bytes))
        self.f.close()


class RawFileSink(Sink):
    def __init__(self, path: str):
        self.f = open(path, "wb")

    def push(self, pcm: np.ndarray) -> None:
        self.f.write(np.ascontiguousarray(pcm.astype("<i2")).tobytes())

    def close(self) -> None:
        self.f.close()


class CallbackSink(Sink):
    def __init__(self, fn):
        self.fn = fn

    def push(self, pcm: np.ndarray) -> None:
        self.fn(pcm)


class CollectSink(Sink):
    """Accumulates all pushed PCM (tests/offline decode)."""

    def __init__(self):
        self.chunks: list[np.ndarray] = []

    def push(self, pcm: np.ndarray) -> None:
        self.chunks.append(np.asarray(pcm))

    @property
    def pcm(self) -> np.ndarray:
        if not self.chunks:
            return np.zeros((0, 2), np.int16)
        return np.concatenate(self.chunks, axis=0)


class RingBuffer:
    """Thread-safe PCM ring buffer with underrun/overrun counters —
    the producer/consumer seam whose absence caused the reference
    player's audible crackling (SURVEY.md §0.1, §5.2)."""

    def __init__(self, capacity_samples: int, channels: int):
        self.buf = np.zeros((capacity_samples, channels), np.int16)
        self.cap = capacity_samples
        self.r = 0
        self.w = 0
        self.fill = 0
        self.underruns = 0
        self.overruns = 0
        self.lock = threading.Lock()

    def push(self, pcm: np.ndarray) -> int:
        with self.lock:
            n = min(len(pcm), self.cap - self.fill)
            if n < len(pcm):
                self.overruns += 1
            first = min(n, self.cap - self.w)
            self.buf[self.w:self.w + first] = pcm[:first]
            rest = n - first
            if rest:
                self.buf[:rest] = pcm[first:n]
            self.w = (self.w + n) % self.cap
            self.fill += n
            return n

    def pop(self, n: int) -> np.ndarray:
        with self.lock:
            avail = min(n, self.fill)
            if avail < n:
                self.underruns += 1
            out = np.zeros((n, self.buf.shape[1]), np.int16)
            first = min(avail, self.cap - self.r)
            out[:first] = self.buf[self.r:self.r + first]
            rest = avail - first
            if rest:
                out[first:avail] = self.buf[:rest]
            self.r = (self.r + avail) % self.cap
            self.fill -= avail
            return out


class RealtimeSink(Sink):
    """Realtime audio-device sink (ALSA/PortAudio) behind a feature flag
    (SURVEY.md D7): TPU hosts ship no audio stack, so this is present
    for API completeness and activates only when MP3TPU_AUDIO_DEVICE is
    set and a backend module is importable. Falls back to a RingBuffer
    consumer model either way, so underrun accounting works headlessly.
    """

    def __init__(self, sample_rate: int, channels: int,
                 capacity_samples: int = 65536):
        import os
        self.ring = RingBuffer(capacity_samples, channels)
        self.sample_rate = sample_rate
        self.backend = None
        dev = os.environ.get("MP3TPU_AUDIO_DEVICE")
        if dev:
            try:  # pragma: no cover - no audio stack on TPU hosts
                import alsaaudio  # type: ignore
                pcm = alsaaudio.PCM(rate=sample_rate, channels=channels,
                                    device=dev)
                self.backend = pcm
            except Exception:
                self.backend = None

    @property
    def underruns(self) -> int:
        return self.ring.underruns

    def push(self, pcm: np.ndarray) -> None:
        self.ring.push(pcm)
        if self.backend is not None:  # pragma: no cover
            chunk = self.ring.pop(len(pcm))
            self.backend.write(chunk.tobytes())
