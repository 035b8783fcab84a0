"""Packed-bytes bitstream mux (SURVEY.md E6, batch fast path).

Counterpart of mp3tpu.encoder.mux_packed. assemble_stream() is
ReservoirMux + build-frame re-expressed over the row emitter's packed
granule bytes: the logical main-data stream is assembled by OR-ing each
granule's byte block in at its bit offset (one vectorized shift per granule
instead of per-bit list appends), side info packs via one
BitWriter.put_array call for ALL frames, and physical frames are sliced out
exactly as ReservoirMux.finish does. Byte-identical to the
CodedGranule/ReservoirMux path for the same granule data (tested).
"""
from __future__ import annotations

import numpy as np

from ..bitstream.bitwriter import BitWriter
from .mux import FrameSizer, ReservoirMux, frame_capacity_bits

MAX_BACK = ReservoirMux.MAX_BACK


FORCE_PYTHON_MUX = False  # test hook: pin the Python reference mux


def assemble_stream(bits_bytes: np.ndarray, p23: np.ndarray,
                    bv: np.ndarray, gg: np.ndarray, sfc: np.ndarray,
                    block_type: np.ndarray, tsel: np.ndarray,
                    sbg: np.ndarray, r0c: np.ndarray, r1c: np.ndarray,
                    c1t: np.ndarray, ms_f: np.ndarray,
                    nch: int, sr_idx: int, br_idx: int,
                    sample_rate: int, bitrate: int,
                    require_native: bool = False) -> bytes:
    """One stream's frames from per-granule packed bits + side fields.

    bits_bytes [n_gc, cap] uint8 (MSB-first, zero-padded); all other
    per-gc arrays ordered frame-major, granule-major, channel-minor.
    Dispatches to the C++ mux (csrc/mux_stream.cpp) when the host library
    is there; this module's _assemble_python is the semantics reference,
    byte-identical (tested both ways, incl. reservoir-clamp-saturated quiet
    streams), and what a host without the library runs. require_native
    (the encoder on the card) raises instead of running the Python mux."""
    if not FORCE_PYTHON_MUX:
        body = _assemble_native(bits_bytes, p23, bv, gg, sfc, block_type,
                                tsel, sbg, r0c, r1c, c1t, ms_f, nch,
                                sr_idx, br_idx, sample_rate, bitrate)
        if body is not None:
            return body
        if require_native:
            raise RuntimeError("the C++ stream mux is unavailable or refused "
                               "the stream (MP3TPU_NO_NATIVE set, or no g++)")
    return _assemble_python(bits_bytes, p23, bv, gg, sfc, block_type,
                            tsel, sbg, r0c, r1c, c1t, ms_f, nch,
                            sr_idx, br_idx, sample_rate, bitrate)


def _assemble_native(bits_bytes, p23, bv, gg, sfc, block_type, tsel, sbg,
                     r0c, r1c, c1t, ms_f, nch, sr_idx, br_idx,
                     sample_rate, bitrate):
    from ..bitstream import native as _nat
    lib = _nat._load()
    if lib is None:
        return None
    n_gc = len(p23)
    n_frames = n_gc // (2 * nch)
    # worst-case output: every frame padded
    out_cap = n_frames * (144 * bitrate * 1000 // sample_rate + 1)
    out = np.empty(out_cap, np.uint8)
    i32 = lambda a: np.ascontiguousarray(a, np.int32)
    bb = np.ascontiguousarray(bits_bytes, np.uint8)
    arrs = [i32(a) for a in (p23, bv, gg, sfc, block_type,
                             tsel, sbg, r0c, r1c, c1t)]
    msb = np.ascontiguousarray(np.asarray(ms_f, np.uint8))
    assert len(msb) == n_frames, (len(msb), n_frames)
    n = lib.mp3tpu_mux_stream(
        bb.ctypes.data, n_gc, bb.shape[1], *[a.ctypes.data for a in arrs],
        msb.ctypes.data, nch, sr_idx, br_idx, sample_rate, bitrate * 1000,
        MAX_BACK, out.ctypes.data, out_cap)
    if n < 0:
        return None
    return bytes(out[:n].tobytes())


def _assemble_python(bits_bytes: np.ndarray, p23: np.ndarray,
                     bv: np.ndarray, gg: np.ndarray, sfc: np.ndarray,
                     block_type: np.ndarray, tsel: np.ndarray,
                     sbg: np.ndarray, r0c: np.ndarray, r1c: np.ndarray,
                     c1t: np.ndarray, ms_f: np.ndarray,
                     nch: int, sr_idx: int, br_idx: int,
                     sample_rate: int, bitrate: int) -> bytes:
    """Pure-Python reference implementation (see assemble_stream)."""
    n_gc = len(p23)
    n_frames = n_gc // (2 * nch)
    sizer = FrameSizer(sample_rate, bitrate * 1000)
    fsizes = [sizer.next() for _ in range(n_frames)]
    cap_f = np.array([frame_capacity_bits(fb, nch) for fb, _ in fsizes],
                     np.int64)

    # ---- reservoir walk: per-gc bit offsets in the logical stream,
    # per-frame main_data_begin (exact ReservoirMux.add_frame replay)
    off = np.zeros(n_gc, np.int64)
    mdb_f = np.zeros(n_frames, np.int64)
    stream_bits = 0
    placed_bytes = 0
    for f in range(n_frames):
        mdb = placed_bytes - stream_bits // 8
        assert 0 <= mdb <= 511, mdb
        mdb_f[f] = mdb
        g0 = f * 2 * nch
        for i in range(2 * nch):
            off[g0 + i] = stream_bits
            stream_bits += int(p23[g0 + i])
        stream_bits = (stream_bits + 7) & ~7
        placed_bytes += int(cap_f[f]) // 8
        assert stream_bits <= placed_bytes * 8, "reservoir overdraft"
        excess = placed_bytes - stream_bits // 8 - MAX_BACK
        if excess > 0:
            stream_bits += excess * 8

    # ---- logical main-data stream: OR each granule's shifted bytes in
    data = np.zeros(placed_bytes + 4, np.uint8)
    cap = bits_bytes.shape[1]
    for i in range(n_gc):
        nb = int(p23[i])
        if nb == 0:
            continue
        o = int(off[i])
        sh = o & 7
        nby = (nb + 7) // 8
        src = bits_bytes[i, : min(nby, cap)]
        if sh == 0:
            data[o >> 3: (o >> 3) + len(src)] |= src
        else:
            ext = np.concatenate([np.zeros(1, np.uint8), src]).astype(np.uint16)
            # out[k] = src[k-1] << (8-sh) | src[k] >> sh  (MSB-first)
            out = ((ext[:-1] << (8 - sh)) | (ext[1:] >> sh)).astype(np.uint8)
            tail = np.uint8((int(src[-1]) << (8 - sh)) & 0xFF)
            seg = np.concatenate([out, tail[None]])
            data[o >> 3: (o >> 3) + len(seg)] |= seg

    # ---- side info for ALL frames in one put_array ------------------
    w = BitWriter()
    V, L = [], []
    for f in range(n_frames):
        V.append(int(mdb_f[f])); L.append(9)
        V.append(0); L.append(5 if nch == 1 else 3)
        for _ch in range(nch):
            V.append(0); L.append(4)              # scfsi
        for i in range(f * 2 * nch, (f + 1) * 2 * nch):
            wsw = 1 if block_type[i] else 0
            V += [int(p23[i]), int(bv[i]), int(gg[i]), int(sfc[i]), wsw]
            L += [12, 9, 8, 4, 1]
            if wsw:
                V += [int(block_type[i]), 0,
                      int(tsel[i, 0]), int(tsel[i, 1]),
                      int(sbg[i, 0]), int(sbg[i, 1]), int(sbg[i, 2])]
                L += [2, 1, 5, 5, 3, 3, 3]
            else:
                V += [int(tsel[i, 0]), int(tsel[i, 1]), int(tsel[i, 2]),
                      int(r0c[i]), int(r1c[i])]
                L += [5, 5, 5, 4, 3]
            V += [0, 0, int(c1t[i])]
            L += [1, 1, 1]
    w.put_array(np.asarray(V, np.int64), np.asarray(L, np.int64))
    side_bytes = 17 if nch == 1 else 32
    sides = np.packbits(np.asarray(w.bits, np.uint8)).reshape(
        n_frames, side_bytes)

    # ---- headers + physical frame slicing (ReservoirMux.finish) -----
    out = bytearray()
    pos = 0
    hdr_len = 4 + side_bytes
    for f in range(n_frames):
        frame_bytes, pad = fsizes[f]
        wh = BitWriter()
        wh.put(0x7FF, 11); wh.put(0b11, 2); wh.put(0b01, 2); wh.put(1, 1)
        wh.put(br_idx, 4); wh.put(sr_idx, 2); wh.put(pad, 1); wh.put(0, 1)
        ms = bool(ms_f[f])
        if nch == 1:
            wh.put(0b11, 2)
        else:
            wh.put(0b01 if ms else 0b00, 2)
        wh.put(0b10 if ms else 0, 2)
        wh.put(0, 1); wh.put(1, 1); wh.put(0, 2)
        hdr = wh.to_bytes() + sides[f].tobytes()
        capb = frame_bytes - hdr_len
        chunk = data[pos: pos + capb].tobytes()
        chunk += b"\x00" * (capb - len(chunk))
        out += hdr + chunk
        pos += capb
    return bytes(out)
