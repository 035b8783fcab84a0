"""Streaming symbol access (SURVEY.md §3.3 refill loop, §5.7).

SymbolSource materializes SymbolTensors granule ranges on demand with
O(window) host memory and O(window) first-audio latency: sequential
reads continue the carried bit-reservoir state; backward jumps restart
exactly by re-seeding the reservoir with the preceding frames' main
data (byte appends, no decoding — see WindowedUnpacker.restart_at).

Uses the C++ windowed unpacker when available (bit-identical to the
pure-Python path; tested), falling back to Python transparently.

Copy of mp3tpu.bitstream.source, kept in the port so that it imports nothing of
the JAX package; the code is the same.
"""
from __future__ import annotations

import numpy as np

from ..container import frames as fr
from . import native
from .unpack import SymbolTensors, WindowedUnpacker


class SymbolSource:
    """On-demand SymbolTensors over one stream."""

    def __init__(self, data: bytes, index: fr.FrameIndex | None = None,
                 skip_frames: int = 0):
        self._data = bytes(data)
        self._py = WindowedUnpacker(self._data, index)
        self._skip = skip_frames  # leading metadata (Xing) frames
        from .unpack import use_native
        self._native_state = (native.NativeWindowState()
                              if use_native() else None)
        self._native_cursor = 0
        self.sample_rate = self._py.sr
        self.channels = self._py.nch
        self.version = self._py.index.version
        self.ngr = self._py.ngr
        self.n_granules = (self._py.n_frames - skip_frames) * self.ngr
        # observability: how much host work this source has done
        self.granules_unpacked = 0
        self.restarts = 0
        if skip_frames:
            self._seek_frame(skip_frames)

    # ------------------------------------------------------------ internal
    def _seek_frame(self, f0: int) -> None:
        """Position the unpack cursor at absolute frame f0 exactly."""
        cur = (self._native_cursor if self._native_state is not None
               else self._py.cursor)
        if f0 == cur:
            return
        if f0 > cur:
            a, b = cur, f0  # roll forward: seed skipped frames' main data
        else:
            self.restarts += 1
            a = self._py.reservoir_start_frame(f0)
            b = f0
            if self._native_state is not None:
                self._native_state.reset()
            else:
                self._py.reservoir = bytearray()
                self._py.res_trim = 0
        if self._native_state is not None:
            chunk = b"".join(
                self._data[s:e]
                for s, e in (self._py._main_span(fi) for fi in range(a, b)))
            self._native_state.seed_bytes(chunk)
            self._native_cursor = f0
        else:
            self._py.cursor = a
            self._py.seed(a, b)

    def _unpack(self, f0: int, f1: int) -> SymbolTensors:
        self._seek_frame(f0)
        self.granules_unpacked += (f1 - f0) * self.ngr
        if self._native_state is not None:
            st = native.unpack_native_window(self._data, f0, f1,
                                             self._native_state)
            if st is not None:
                self._native_cursor = f1
                return st
            self._native_state = None  # fall back permanently
            self._py.cursor = 0
            self._seek_frame(f0)
        return self._py.unpack_frames(f1)

    # ------------------------------------------------------------- public
    def granules(self, g0: int, g1: int) -> SymbolTensors:
        """SymbolTensors for granules [g0, g1) (local rows). Granule 0 is
        the first audio granule (metadata frames skipped)."""
        assert 0 <= g0 <= g1 <= self.n_granules
        ngr = self.ngr
        f0 = self._skip + g0 // ngr
        f1 = self._skip + -(-g1 // ngr)
        st = self._unpack(f0, f1)
        lo = g0 - (f0 - self._skip) * ngr
        return st.slice_granules(lo, lo + (g1 - g0))

    def whole(self) -> SymbolTensors:
        """Materialize the full stream (batch paths)."""
        return self.granules(0, self.n_granules)


def unpack_parallel(data: bytes, index: fr.FrameIndex | None = None,
                    chunk_granules: int = 1024,
                    max_workers: int = 4) -> SymbolTensors:
    """Host-parallel unpack of ONE long file (SURVEY.md §5.7 host side).

    The bit reservoir makes unpacking sequential within a stream, but
    only over a <=511-byte lookback — so a long file is chunked at
    frame boundaries, each chunk's reservoir is seeded EXACTLY from the
    preceding frames' main data (SymbolSource._seek_frame walks back
    until the back-pointer resolves; stronger than the Xing-TOC
    "2-frame pre-roll" heuristic since the FrameIndex is already in
    hand), and chunks unpack concurrently in a thread pool — the C++
    unpacker releases the GIL, so this scales with cores. Output is
    bit-identical to a serial whole-file unpack (tested).
    """
    from concurrent.futures import ThreadPoolExecutor

    buf = np.frombuffer(data, np.uint8)
    if index is None:
        index = fr.scan_frames(buf)
    probe = SymbolSource(data, index=index)
    G = probe.n_granules
    step = max(probe.ngr, (chunk_granules // probe.ngr) * probe.ngr)
    ranges = [(g, min(g + step, G)) for g in range(0, G, step)]
    if len(ranges) <= 1:
        return probe.whole()

    def work(r):
        src = SymbolSource(data, index=index)
        return src.granules(*r)

    with ThreadPoolExecutor(max_workers=max_workers) as ex:
        parts = list(ex.map(work, ranges))
    return SymbolTensors.concat(parts)
