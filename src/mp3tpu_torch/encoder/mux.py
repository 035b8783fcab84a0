"""Bitstream assembly (SURVEY.md E6) — ISO 11172-3 §2.4.1 syntax writer.

CBR frames with the standard padding-slot accumulator. Two muxing
modes: ReservoirMux (default; granule data forms one logical stream
with main_data_begin back-pointers so loud granules borrow capacity)
and simple per-frame assembly (main_data_begin = 0, random-access
friendly). First frame carries a Xing + LAME-format tag (frame count,
byte count, seek TOC, encoder delay/padding for gapless decode).

Copy of mp3tpu.encoder.mux, kept in the port so that it imports nothing of
the JAX package; the code is the same.
"""
from __future__ import annotations

import numpy as np

from ..bitstream.bitwriter import BitWriter
from .huffcode import CodedGranule


def _header_word(sr_idx: int, br_idx: int, padding: int, nch: int,
                 ms: bool = False) -> BitWriter:
    w = BitWriter()
    w.put(0x7FF, 11)
    w.put(0b11, 2)       # MPEG-1
    w.put(0b01, 2)       # Layer III
    w.put(1, 1)          # no CRC
    w.put(br_idx, 4)
    w.put(sr_idx, 2)
    w.put(padding, 1)
    w.put(0, 1)          # private
    if nch == 1:
        w.put(0b11, 2)   # single channel
    else:
        w.put(0b01 if ms else 0b00, 2)  # joint stereo / stereo
    w.put(0b10 if ms else 0, 2)         # mode extension: MS on
    w.put(0, 1)          # copyright
    w.put(1, 1)          # original
    w.put(0, 2)          # emphasis
    return w


def _side_info(granules, nch: int) -> BitWriter:
    """granules: [2][nch] CodedGranule."""
    w = BitWriter()
    w.put(0, 9)                       # main_data_begin (ReservoirMux patches this)
    w.put(0, 5 if nch == 1 else 3)    # private bits
    for _ch in range(nch):
        w.put(0, 4)                   # scfsi (no sharing)
    for gr in range(2):
        for ch in range(nch):
            g: CodedGranule = granules[gr][ch]
            w.put(g.part2_3_length, 12)
            w.put(g.big_values, 9)
            w.put(g.global_gain, 8)
            w.put(g.scalefac_compress, 4)
            w.put(g.window_switching, 1)
            if g.window_switching:
                w.put(g.block_type, 2)
                w.put(0, 1)           # mixed_block_flag
                for t in g.table_select[:2]:
                    w.put(t, 5)
                for s in g.subblock_gain:
                    w.put(s, 3)
            else:
                for t in g.table_select:
                    w.put(t, 5)
                w.put(g.region0_count, 4)
                w.put(g.region1_count, 3)
            w.put(g.preflag, 1)
            w.put(g.scalefac_scale, 1)
            w.put(g.count1table_select, 1)
    return w


class FrameSizer:
    """CBR frame lengths with the padding-slot accumulator."""

    def __init__(self, sample_rate: int, bitrate: int):
        self.base = 144 * bitrate // sample_rate
        self.rem = (144 * bitrate) % sample_rate
        self.sr = sample_rate
        self.acc = 0

    def next(self) -> tuple[int, int]:
        """(frame_bytes, padding_bit)"""
        self.acc += self.rem
        if self.acc >= self.sr:
            self.acc -= self.sr
            return self.base + 1, 1
        return self.base, 0


def frame_capacity_bits(frame_bytes: int, nch: int) -> int:
    side = 17 if nch == 1 else 32
    return (frame_bytes - 4 - side) * 8


def build_frame(granules, nch: int, sr_idx: int, br_idx: int,
                frame_bytes: int, padding: int, ms: bool = False) -> bytes:
    w = _header_word(sr_idx, br_idx, padding, nch, ms)
    w.put_bits(_side_info(granules, nch))
    for gr in range(2):
        for ch in range(nch):
            w.put_bits(granules[gr][ch].bits)
    return w.to_bytes(pad_to=frame_bytes)


def build_xing_frame(nch: int, sr_idx: int, br_idx: int, frame_bytes: int,
                     n_frames: int, n_bytes: int, encoder_delay: int,
                     encoder_padding: int, toc: bytes | None = None) -> bytes:
    """Metadata-only first frame: Xing flags+frames+bytes+TOC+quality,
    then a LAME-format tag carrying delay/padding (gapless)."""
    empty = [[CodedGranule() for _ in range(nch)] for _ in range(2)]
    w = _header_word(sr_idx, br_idx, 0, nch)
    w.put_bits(_side_info(empty, nch))
    body = bytearray(w.to_bytes())
    body += b"Xing"
    body += (0xF).to_bytes(4, "big")           # frames|bytes|toc|quality
    body += n_frames.to_bytes(4, "big")
    body += n_bytes.to_bytes(4, "big")
    body += (toc if toc is not None
             else bytes((np.arange(100) * 256 // 100).astype(np.uint8)))
    body += (100).to_bytes(4, "big")
    lame = bytearray(b"LAME3.100")              # tag magic + version field
    lame += b"\x00" * 12                        # revision/quality/peak/gain fields
    v = (encoder_delay << 12) | encoder_padding
    lame += bytes(((v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF))
    lame += b"\x00" * 12                        # flags/gains/crc placeholder
    body += bytes(lame)
    assert len(body) <= frame_bytes
    return bytes(body) + b"\x00" * (frame_bytes - len(body))


class ReservoirMux:
    """Bit-reservoir frame assembly (SURVEY.md E6, ISO §2.4.1.7):
    granule main data forms one logical bit stream; each frame's header
    points back (main_data_begin <= 511 bytes) to where its granules
    start, so loud granules can borrow capacity that quiet ones left
    unused. Each frame's granule group starts byte-aligned (decoders
    index the stream in bytes).
    """

    MAX_BACK = 400  # keep main_data_begin comfortably below the 511 cap

    def __init__(self, nch: int, sr_idx: int, br_idx: int, sizer: "FrameSizer"):
        self.nch = nch
        self.sr_idx = sr_idx
        self.br_idx = br_idx            # default (CBR) bitrate index
        self.sizer = sizer
        self.stream = BitWriter()       # logical main-data stream
        self.frames: list[tuple] = []   # (granules, ms, frame_bytes, pad, mdb, br_idx)
        self.placed_bytes = 0           # capacity of frames so far

    @property
    def reservoir_bits(self) -> int:
        """unused capacity so far = borrowable bits for the next frame."""
        return self.placed_bytes * 8 - len(self.stream)

    def add_frame(self, granules, ms: bool, br_idx: int | None = None,
                  frame_bytes: int | None = None, pad: int = 0) -> None:
        """granules: [2][nch] CodedGranule (bits already encoded).
        br_idx/frame_bytes override the CBR sizer for VBR frames."""
        if frame_bytes is None:
            frame_bytes, pad = self.sizer.next()
        if br_idx is None:
            br_idx = self.br_idx
        cap_bits = frame_capacity_bits(frame_bytes, self.nch)
        mdb = self.placed_bytes - len(self.stream) // 8
        assert 0 <= mdb <= 511, mdb
        for gr in range(2):
            for ch in range(self.nch):
                self.stream.put_bits(granules[gr][ch].bits)
        # frame data groups start byte-aligned in the logical stream
        while len(self.stream) % 8:
            self.stream.put(0, 1)
        self.placed_bytes += cap_bits // 8
        assert len(self.stream) <= self.placed_bytes * 8, "reservoir overdraft"
        self.frames.append((granules, ms, frame_bytes, pad, mdb, br_idx))
        # cap the back-pointer: dump stuffing when too much is unused
        excess = self.placed_bytes - len(self.stream) // 8 - self.MAX_BACK
        if excess > 0:
            self.stream.put(0, excess * 8)

    def finish(self) -> bytes:
        data = self.stream.to_bytes()
        out = []
        pos = 0  # bytes of the logical stream consumed by physical frames
        for granules, ms, frame_bytes, pad, mdb, br_idx in self.frames:
            w = _header_word(self.sr_idx, br_idx, pad, self.nch, ms)
            side = _side_info(granules, self.nch)
            # overwrite main_data_begin (first 9 bits of side info)
            for i in range(9):
                side.bits[i] = (mdb >> (8 - i)) & 1
            w.put_bits(side)
            hdr = w.to_bytes()
            cap = frame_bytes - len(hdr)
            chunk = data[pos: pos + cap]
            chunk += b"\x00" * (cap - len(chunk))
            out.append(hdr + chunk)
            pos += cap
        return b"".join(out)
