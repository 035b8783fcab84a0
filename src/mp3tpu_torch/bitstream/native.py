"""ctypes loader for the C++ host library: the fast-path unpacker (SURVEY.md
B2/B4) and the encoder's stream mux (E6).

Counterpart of mp3tpu.bitstream.native, with the same functions and
routing. It builds the port's copies, csrc/unpack.cpp and
csrc/mux_stream.cpp with csrc/spec_tables.h, into one library with g++
at first use (kernels/build.py: the Makefile's flags less -flto, into
build/mp3tpu_torch/, under the build lock). MP3TPU_NO_NATIVE (or
decode.use_native=False) leaves the pure-Python paths (unpack.py,
huffcode.encode_granule, mux_packed._assemble_python), the semantics
oracles, as in the JAX package. A host without g++ has no library either;
where g++ is there, a failed build or load raises instead of falling back.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from ..kernels import build

_lib = None
_checked = False


def available() -> bool:
    return _load() is not None


def _load():
    """The unpacker's library, or None when MP3TPU_NO_NATIVE is set or the
    host has no C++ compiler. Raises when the build or the load fails."""
    global _lib, _checked
    if _checked:
        return _lib
    if os.environ.get("MP3TPU_NO_NATIVE") or build.cxx_path() is None:
        _checked = True
        return None
    lib = ctypes.CDLL(str(build.build("unpack.cpp")))
    lib.mp3tpu_probe.restype = ctypes.c_int
    lib.mp3tpu_probe.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32)]
    lib.mp3tpu_unpack.restype = ctypes.c_int
    lib.mp3tpu_unpack.argtypes = [ctypes.c_char_p, ctypes.c_int64] + [
        ctypes.c_void_p] * 8 + [ctypes.c_int32] * 3 + [
        ctypes.c_void_p] * 2 + [ctypes.c_int32]
    lib.mp3tpu_unpack_window.restype = ctypes.c_int
    lib.mp3tpu_unpack_window.argtypes = (
        [ctypes.c_char_p, ctypes.c_int64] + [ctypes.c_int32] * 2 +
        [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32] +
        [ctypes.c_void_p] * 8 + [ctypes.c_int32] * 3 +
        [ctypes.c_void_p] * 2 + [ctypes.c_int32])
    lib.mp3tpu_mux_stream.restype = ctypes.c_int64
    lib.mp3tpu_mux_stream.argtypes = (
        [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64] +
        [ctypes.c_void_p] * 11 + [ctypes.c_int32] * 6 +
        [ctypes.c_void_p, ctypes.c_int64])
    _lib, _checked = lib, True
    return _lib


def unpack_native(data: bytes):
    """C++ unpack -> SymbolTensors, or None if unavailable/failed."""
    from .unpack import SymbolTensors
    lib = _load()
    if lib is None:
        return None
    meta = (ctypes.c_int32 * 4)()
    g = lib.mp3tpu_probe(data, len(data), meta)
    if g <= 0:
        return None
    G = g
    is_ = np.zeros((G, 2, 576), np.int16)
    exp = np.zeros((G, 2, 64), np.int16)
    bt = np.zeros((G, 2), np.int8)
    mixed = np.zeros((G, 2), np.uint8)
    smode = np.zeros((G, 64), np.uint8)
    err = np.zeros(G, np.int16)
    slack = np.zeros((G, 2), np.int32)
    lines = np.zeros((G, 2), np.int32)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    r = lib.mp3tpu_unpack(data, len(data), ptr(is_), ptr(exp), ptr(bt),
                          ptr(mixed), ptr(smode), ptr(err), ptr(slack), ptr(lines),
                          0, 1, 0, None, None, 12)
    if r != G:
        return None
    return SymbolTensors(
        is_=is_, exp=exp, block_type=bt, mixed=mixed.astype(bool), smode=smode,
        errors=err, huff_slack=slack, lines_used=lines,
        sample_rate=int(meta[0]), channels=int(meta[1]), version=int(meta[2]))


def unpack_native_into(data: bytes, G: int, is_, exp, bt, mixed, smode,
                       stream_idx: int = 0, n_streams: int = 1,
                       win: int = 0) -> bool:
    """Unpack directly into caller-provided batch tensors.

    With win == 0: arrays are this stream's [G, ...] slices (contiguous).
    With win > 0: arrays are whole window-major batch tensors shaped
    [n_win, n_streams, win, ...] and this stream's granules are written
    at stream_idx (zero-copy batch assembly). The stream must have
    exactly G = n_win*win granules (callers bucket/pad).
    """
    lib = _load()
    if lib is None:
        return False
    meta = (ctypes.c_int32 * 4)()
    g = lib.mp3tpu_probe(data, len(data), meta)
    if g <= 0 or g != G:
        return False
    err = np.zeros(g, np.int16)
    slack = np.zeros((g, 2), np.int32)
    lines = np.zeros((g, 2), np.int32)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    for a in (is_, exp, bt, mixed, smode):
        assert a.flags["C_CONTIGUOUS"]
    r = lib.mp3tpu_unpack(data, len(data), ptr(is_), ptr(exp), ptr(bt),
                          ptr(mixed), ptr(smode), ptr(err), ptr(slack), ptr(lines),
                          stream_idx, n_streams, win, None, None, 12)
    return r == g


def unpack_native_into12(data: bytes, G: int, is_, exp, bt, mixed, smode,
                         is12, esc, stream_idx: int = 0, n_streams: int = 1,
                         win: int = 0, plane_bits: int = 12,
                         err=None) -> bool:
    """Like unpack_native_into but additionally emits the packed spectrum
    plane + escape channel (transfer-optimized device input).

    plane_bits=12: is12 is uint8 [..., 864], |values|<=2047 inline,
                   esc [..., 16, 2].
    plane_bits=8:  is12 is int8 [..., 576], |values|<=127 inline (1.5x
                   fewer staged bytes; escapes are rare below ~192 kbps),
                   esc [..., 16, 2].
    plane_bits=4:  is12 is uint8 [..., 288], two lines/byte as nibble
                   value+7, nibble 15 = escape; esc [..., 80] int8 is
                   the POSITION-FREE two-level sideband ([:64] values in
                   line order, marker -128 = |v|>127 whose low/high
                   bytes sit at [64:72]/[72:80] by rank) — 1.7x fewer
                   staged bytes than the 8-bit plane.
    plane_bits may carry flag 0x10: exponents write as the compact
    uint8[..., 65] plane ([gg, band_offset+128] per gc — half the
    staged bytes of int16[..., 64]; offsets outside [-128, 0], possible
    only under LSF, refuse so the caller falls back to int16).
    Returns False on sideband/offset overflow per granule-channel
    (caller falls back to the int16 plane or a wider packed plane)."""
    lib = _load()
    if lib is None:
        return False
    meta = (ctypes.c_int32 * 4)()
    g = lib.mp3tpu_probe(data, len(data), meta)
    if g <= 0 or g != G:
        return False
    if err is None:
        err = np.zeros(g, np.int16)
    else:  # caller-observed fault flags (Metrics feeding, §5.3/§5.5)
        assert err.dtype == np.int16 and err.size == g
    slack = np.zeros((g, 2), np.int32)
    lines = np.zeros((g, 2), np.int32)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p) if a is not None else None
    for a in (is_, exp, bt, mixed, smode, is12, esc, err):
        assert a is None or a.flags["C_CONTIGUOUS"]
    r = lib.mp3tpu_unpack(data, len(data), ptr(is_), ptr(exp), ptr(bt),
                          ptr(mixed), ptr(smode), ptr(err), ptr(slack), ptr(lines),
                          stream_idx, n_streams, win, ptr(is12), ptr(esc),
                          plane_bits)
    return r == g


RES_STATE_CAP = 4096


class NativeWindowState:
    """Carried reservoir state for the C++ windowed unpacker."""

    def __init__(self):
        self.buf = np.zeros(RES_STATE_CAP, np.uint8)
        self.len = ctypes.c_int32(0)

    def seed_bytes(self, chunk: bytes) -> None:
        """Append raw main-data bytes (seek pre-roll), keeping the tail."""
        cur = bytes(self.buf[: self.len.value].tobytes()) + chunk
        keep = cur[-1024:]
        self.buf[: len(keep)] = np.frombuffer(keep, np.uint8)
        self.len.value = len(keep)

    def reset(self):
        self.len.value = 0


def unpack_native_window(data: bytes, f0: int, f1: int,
                         state: NativeWindowState):
    """C++ windowed unpack of frames [f0, f1) -> SymbolTensors (local
    rows) with the reservoir carried in `state`, or None if the native
    library is unavailable. Bit-identical to the same rows of
    unpack()/unpack_native() (tested)."""
    from .unpack import SymbolTensors
    lib = _load()
    if lib is None:
        return None
    meta = (ctypes.c_int32 * 4)()
    g_total = lib.mp3tpu_probe(data, len(data), meta)
    if g_total <= 0:
        return None
    nfr = f1 - f0
    ngr = g_total // int(meta[3])  # granules per frame (2 MPEG-1, 1 LSF)
    G = nfr * ngr
    is_ = np.zeros((G, 2, 576), np.int16)
    exp = np.zeros((G, 2, 64), np.int16)
    bt = np.zeros((G, 2), np.int8)
    mixed = np.zeros((G, 2), np.uint8)
    smode = np.zeros((G, 64), np.uint8)
    err = np.zeros(G, np.int16)
    slack = np.zeros((G, 2), np.int32)
    lines = np.zeros((G, 2), np.int32)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    r = lib.mp3tpu_unpack_window(
        data, len(data), f0, f1,
        ptr(state.buf), ctypes.byref(state.len), RES_STATE_CAP,
        ptr(is_), ptr(exp), ptr(bt), ptr(mixed), ptr(smode),
        ptr(err), ptr(slack), ptr(lines), 0, 1, 0, None, None, 12)
    if r != G:
        return None
    return SymbolTensors(
        is_=is_, exp=exp, block_type=bt, mixed=mixed.astype(bool), smode=smode,
        errors=err, huff_slack=slack, lines_used=lines,
        sample_rate=int(meta[0]), channels=int(meta[1]), version=int(meta[2]))
