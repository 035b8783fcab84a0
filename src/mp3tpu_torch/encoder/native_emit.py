"""ctypes glue for the native batched granule emitter (SURVEY.md E5/E6).

Counterpart of mp3tpu.encoder.native_emit. encode_rows_packed emits R
granule-channel rows through the C++ emitter (csrc/encode_rows.cpp, in the
library bitstream/native.py builds) as packed byte rows and side-info
fields; encode_rows_native wraps them as CodedGranule objects, bit for bit
what huffcode.encode_granule produces (tested row for row). The Python
emitter stays the semantics reference. Both return None where the host has
no C++ library (no g++, or MP3TPU_NO_NATIVE): the caller then emits in
Python, or raises where it runs on the card.
"""
from __future__ import annotations

import numpy as np

from ..bitstream import native as _nat
from ..bitstream.bitwriter import BitWriter
from .huffcode import CodedGranule

_CAP = 520  # bytes per row: part2_3_length is a 12-bit field (<= 4095
#             bits = 512 bytes); 520 leaves slack for the overflow flag

_SR9 = {44100: 0, 48000: 1, 32000: 2}  # MPEG-1 rows of SR_LIST


def available() -> bool:
    return _nat._load() is not None


def encode_rows_packed(ix: np.ndarray, block_type: np.ndarray,
                       use_sf: np.ndarray, long_sf: np.ndarray,
                       short_sf: np.ndarray, tsel: np.ndarray,
                       c1table: np.ndarray, sample_rate: int):
    """Emit all rows; returns (bits [R, _CAP] uint8 MSB-first, meta [R, 6]
    int32 = part2_3_length, big_values, scalefac_compress, region0_count,
    region1_count, overflow), or None if the library is unavailable or a
    row overflowed.

    ix [R,576]; block_type [R]; use_sf [R] (transmit scalefactors: the
    psy path's rows); long_sf [R,21]; short_sf [R,3,12]; tsel [R,3] table
    ids; c1table [R].
    """
    lib = _nat._load()
    if lib is None:
        return None
    R = len(ix)
    ix16 = np.ascontiguousarray(ix, np.int16)
    bt8 = np.ascontiguousarray(block_type, np.uint8)
    us8 = np.ascontiguousarray(use_sf, np.uint8)
    lsf = np.ascontiguousarray(long_sf, np.int16)
    ssf = np.ascontiguousarray(np.asarray(short_sf).reshape(R, 36), np.int16)
    ts = np.ascontiguousarray(tsel, np.int16)
    c1 = np.ascontiguousarray(c1table, np.uint8)
    bits = np.zeros((R, _CAP), np.uint8)
    meta = np.zeros((R, 6), np.int32)
    p = lambda a: a.ctypes.data
    r = lib.mp3tpu_encode_rows(p(ix16), p(bt8), p(us8), p(lsf), p(ssf), p(ts),
                               p(c1), _SR9[sample_rate], R, p(bits), _CAP,
                               p(meta))
    if r != 0:
        return None
    return bits, meta


def encode_rows_native(ix: np.ndarray, block_type: np.ndarray,
                       use_sf: np.ndarray, long_sf: np.ndarray,
                       short_sf: np.ndarray, sbg: np.ndarray,
                       gg: np.ndarray, tsel: np.ndarray,
                       c1table: np.ndarray, sample_rate: int):
    """encode_rows_packed's rows as list[CodedGranule], or None if
    unavailable. sbg [R,3]; gg [R]; the rest as encode_rows_packed."""
    packed = encode_rows_packed(ix, block_type, use_sf, long_sf, short_sf,
                                tsel, c1table, sample_rate)
    if packed is None:
        return None
    bits, meta = packed
    out = []
    unpacked = np.unpackbits(bits, axis=1)
    for i in range(len(ix)):
        g = CodedGranule(
            part2_3_length=int(meta[i, 0]),
            big_values=int(meta[i, 1]),
            global_gain=int(gg[i]),
            scalefac_compress=int(meta[i, 2]),
            window_switching=1 if block_type[i] else 0,
            block_type=int(block_type[i]),
            table_select=tuple(int(t) for t in tsel[i]),
            subblock_gain=tuple(int(s) for s in sbg[i]),
            region0_count=int(meta[i, 3]),
            region1_count=int(meta[i, 4]),
            count1table_select=int(c1table[i]),
        )
        w = BitWriter()
        w.bits = unpacked[i, : meta[i, 0]].tolist()
        g.bits = w
        out.append(g)
    return out
