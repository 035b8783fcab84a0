"""Host-side Huffman spectrum decoding (SURVEY.md B4) — ISO 11172-3
§2.4.3.4.6 + Annex B.7 tables.

LUT-based: each table is compiled at import into a flat 2^maxlen lookup
(value-pair + code length packed into int32), so decoding one symbol is a
peek + one array index. This is the serial hot loop of the host side; the
C++ fast path (mp3tpu/native) mirrors these semantics.

Copy of mp3tpu.bitstream.huffdec, kept in the port so that it imports nothing of
the JAX package; the code is the same.
"""
from __future__ import annotations

import numpy as np

from ..tables import huffman as ht
from ..tables.sfb import LONG, SHORT


class _LUT:
    __slots__ = ("bits", "table", "linbits")

    def __init__(self, lens, codes, ylen, linbits):
        L = int(max(lens)) if len(lens) else 1
        L = max(L, 1)
        lut = np.zeros(1 << L, np.int32)
        for i, (l, c) in enumerate(zip(lens, codes)):
            l = int(l); c = int(c)
            if l == 0:
                continue
            x, y = divmod(i, ylen)
            packed = l | (x << 8) | (y << 16)
            lo = c << (L - l)
            lut[lo: lo + (1 << (L - l))] = packed
        self.bits = L
        self.table = lut
        self.linbits = linbits


_BIG_LUTS: dict[int, _LUT] = {}
_C1_LUTS: dict[int, _LUT] = {}


def _build():
    for tid in range(32):
        info = ht.TABLE_INFO[tid]
        if info is None or tid == 0:
            continue
        lens, codes, xl, yl, linbits = ht.table_arrays(tid)
        _BIG_LUTS[tid] = _LUT(lens, codes, yl, linbits)
    _C1_LUTS[0] = _LUT(ht.COUNT1A_LENS, ht.COUNT1A_CODES, 16, 0)
    _C1_LUTS[1] = _LUT(ht.COUNT1B_LENS, ht.COUNT1B_CODES, 16, 0)


_build()


class GranuleBits:
    """MSB-first reader over one granule's part2/part3 bit span.

    Backed by a Python big int so arbitrary peeks are cheap at granule
    scale (part2_3_length <= 4095 bits).
    """
    __slots__ = ("val", "nbits", "pos")

    def __init__(self, data: bytes, bit_offset: int, nbits: int, guard_bits: int = 64):
        # materialize [bit_offset, bit_offset+nbits) plus a zero guard so
        # peeks past the end read zeros (over-read detection is by position)
        first = bit_offset >> 3
        last = (bit_offset + nbits + 7) >> 3
        chunk = data[first:last]
        v = int.from_bytes(chunk, "big") if chunk else 0
        total = len(chunk) * 8
        lead = bit_offset - first * 8
        # strip leading bits
        v &= (1 << (total - lead)) - 1 if total - lead > 0 else 0
        tail = total - lead - nbits
        if tail > 0:
            v >>= tail
        elif tail < 0:
            v <<= -tail
        self.val = v << guard_bits
        self.nbits = nbits + guard_bits
        self.pos = 0

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos
        self.pos = p + n
        return (self.val >> (self.nbits - p - n)) & ((1 << n) - 1)

    def peek(self, n: int) -> int:
        p = self.pos
        return (self.val >> (self.nbits - p - n)) & ((1 << n) - 1)

    def skip(self, n: int):
        self.pos += n


def region_boundaries(g, sample_rate: int, lsf: bool) -> tuple[int, int, int]:
    """(region1_start, region2_start, big_value_end) in spectral lines
    [ISO 11172-3 §2.4.2.7]."""
    long_bands = LONG[sample_rate]
    bv2 = min(g.big_values * 2, 576)
    if g.window_switching:
        # no transmitted region counts; region2 unused [§2.4.2.7]
        if g.block_type == 2 and not g.mixed_block_flag:
            r1 = 3 * int(SHORT[sample_rate][3])  # 36 at MPEG-1 rates
        else:
            r1 = int(long_bands[8])              # 36 at MPEG-1 rates
        return min(r1, bv2), bv2, bv2
    r0c, r1c = g.region0_count, g.region1_count
    r1 = int(long_bands[min(r0c + 1, 22)])
    r2 = int(long_bands[min(r0c + 1 + r1c + 1, 22)])
    return min(r1, bv2), min(r2, bv2), bv2


def decode_spectrum(br: GranuleBits, g, sample_rate: int, lsf: bool,
                    part3_bits: int) -> tuple[np.ndarray, int, bool]:
    """Decode big-values + count1 regions into is[576] (int32, signed).

    Returns (is_values, count1_end_line, overrun_flag). The reader must be
    positioned at the start of part3 (after scalefactors); decoding stops
    when part3_bits are consumed.
    """
    out = np.zeros(576, np.int32)
    end_pos = br.pos + part3_bits
    r1, r2, bv2 = region_boundaries(g, sample_rate, lsf)
    ts = g.table_select
    pos = 0
    hard_overrun = False
    # big values
    while pos < bv2:
        tid = ts[0] if pos < r1 else (ts[1] if pos < r2 else ts[2])
        lut = _BIG_LUTS.get(tid)
        if lut is None:  # table 0 (all-zero) or unused spec ids 4/14
            pos += 2     # no bits: a granule may end its bits before them
            continue
        # corrupt streams: big_values may claim more symbols than
        # part2_3_length holds — stop at the granule bit boundary
        if br.pos >= end_pos:
            hard_overrun = True
            break
        entry = int(lut.table[br.peek(lut.bits)])
        l = entry & 0xFF
        if l == 0:
            # invalid code (cannot happen with complete tables)
            br.skip(1)
            continue
        br.skip(l)
        x = (entry >> 8) & 0xFF
        y = (entry >> 16) & 0xFF
        if x == 15 and lut.linbits:
            x += br.read(lut.linbits)
        if x:
            if br.read(1):
                x = -x
        if y == 15 and lut.linbits:
            y += br.read(lut.linbits)
        if y:
            if br.read(1):
                y = -y
        out[pos] = x
        out[pos + 1] = y
        pos += 2
    # count1
    c1 = _C1_LUTS[g.count1table_select]
    while br.pos < end_pos and pos <= 572:
        entry = int(c1.table[br.peek(c1.bits)])
        l = entry & 0xFF
        br.skip(l)
        x = (entry >> 8) & 0xFF
        y = (entry >> 16) & 0xFF
        quad = (x << 4) | y
        for j in range(4):
            v = (quad >> (3 - j)) & 1
            if v and br.read(1):
                v = -1
            out[pos + j] = v
        pos += 4
    c1_overrun = br.pos > end_pos
    overrun = hard_overrun or c1_overrun
    slack = end_pos - br.pos  # 0 for conformant streams (or lines full)
    if c1_overrun and pos >= 4:
        # partial last count1 quadruple: discard it [common practice]
        out[pos - 4: pos] = 0
        pos -= 4
    br.pos = end_pos
    return out, max(0, min(pos, 576)), overrun, slack
