"""Huffman coding + table selection + bit counting (SURVEY.md E5) —
ISO 11172-3 §2.4.2.7 / Annex B.7 / Annex C.1.5.4.4.

Bit counting is fully vectorized (numpy length-LUTs per table) because
the inner rate loop calls it per global_gain candidate.

Copy of mp3tpu.encoder.huffcode, kept in the port so that it imports nothing of
the JAX package; the code is the same.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np

from ..bitstream.bitwriter import BitWriter
from ..tables import huffman as ht
from ..tables.sfb import LONG, SLEN1, SLEN2

# tables usable per max value (non-escape); chosen by minimal bits
_PLAIN_TABLES = (1, 2, 3, 5, 6, 7, 8, 9, 10, 11, 12, 13, 15)
_ESC_TABLES_A = (16, 17, 18, 19, 20, 21, 22, 23)   # linbits 1..13
_ESC_TABLES_B = (24, 25, 26, 27, 28, 29, 30, 31)


@lru_cache(maxsize=None)
def _len_lut(tid: int) -> tuple[np.ndarray, int, int]:
    lens, _codes, xl, yl, linbits = ht.table_arrays(tid)
    return np.asarray(lens, np.int32).reshape(xl, yl), xl, linbits


def _count_pair_bits_cached(a, b, mx, nsigns, tid: int) -> int:
    """count_pair_bits with precomputed |x|,|y| arrays (the rate loop
    evaluates many candidate tables over the same pairs)."""
    lut, xl, linbits = _len_lut(tid)
    if xl < 16 and mx >= xl:
        return 1 << 30
    if xl == 16 and mx - 15 >= (1 << linbits):
        return 1 << 30
    if xl < 16:
        bits = int(lut[a, b].sum())
    else:
        bits = int(lut[np.minimum(a, 15), np.minimum(b, 15)].sum())
        bits += linbits * int((a >= 15).sum() + (b >= 15).sum())
    return bits + nsigns


def count_pair_bits(ix: np.ndarray, tid: int) -> int:
    """Total bits to code pairs ix[[n,2]] with table tid (incl. signs,
    linbits); returns a huge number if the table cannot represent them."""
    if tid == 0:
        return 0 if not ix.any() else 1 << 30
    a = np.abs(ix[:, 0])
    b = np.abs(ix[:, 1])
    mx = max(int(a.max(initial=0)), int(b.max(initial=0)))
    nsigns = int((a > 0).sum() + (b > 0).sum())
    return _count_pair_bits_cached(a, b, mx, nsigns, tid)


def best_table(ix_pairs: np.ndarray) -> tuple[int, int]:
    """(table id, bits) minimizing coded size for the given pairs."""
    if not ix_pairs.size or not ix_pairs.any():
        return 0, 0
    a = np.abs(ix_pairs[:, 0])
    b = np.abs(ix_pairs[:, 1])
    mx = max(int(a.max(initial=0)), int(b.max(initial=0)))
    nsigns = int((a > 0).sum() + (b > 0).sum())
    cands = [t for t in _PLAIN_TABLES if mx < _len_lut(t)[1]] if mx < 16 else []
    # every escape table whose linbits can carry the overflow is a legal
    # candidate (escape tables code 0..14 inline too); take the true
    # minimum — matches vcount's min-over-all-valid vectorized selection
    need = max(mx - 15, 0)
    for group in (_ESC_TABLES_A, _ESC_TABLES_B):
        for t in group:
            if need < (1 << ht.TABLE_INFO[t][3]):
                cands.append(t)
    best = (0, 1 << 30)
    for t in cands:
        bits = _count_pair_bits_cached(a, b, mx, nsigns, t)
        if bits < best[1]:
            best = (t, bits)
    return best


_C1A_LENS = np.asarray(ht.COUNT1A_LENS, np.int32)


def count1_bits(quads: np.ndarray, table: int) -> int:
    """Bits for count1 quads [n,4] with table A (0) or B (1)."""
    if not quads.size:
        return 0
    idx = (np.abs(quads[:, 0]) << 3) | (np.abs(quads[:, 1]) << 2) | \
          (np.abs(quads[:, 2]) << 1) | np.abs(quads[:, 3])
    signs = (np.abs(quads) > 0).sum()
    code = _C1A_LENS[idx].sum() if table == 0 else 4 * len(quads)
    return int(code + signs)


@dataclass
class CodedGranule:
    """Everything the mux needs for one granule-channel."""
    part2_3_length: int = 0
    big_values: int = 0
    global_gain: int = 210
    scalefac_compress: int = 0
    window_switching: int = 0
    block_type: int = 0
    table_select: tuple = (0, 0, 0)
    subblock_gain: tuple = (0, 0, 0)
    region0_count: int = 0
    region1_count: int = 0
    preflag: int = 0
    scalefac_scale: int = 0
    count1table_select: int = 0
    bits: BitWriter = field(default_factory=BitWriter)


def split_spectrum(ix: np.ndarray) -> tuple[int, int]:
    """(big_value_pairs, count1_quads) region split: trailing zeros form
    rzero; before them, quads of |v|<=1 form count1; rest is big values.

    The count1 region is anchored on the fixed line-grid of multiples
    of 4 (rzero_start rounds UP to a quad boundary, pulling at most one
    zero pair into the last quad — ~1 bit): big_values is then always
    even and the vectorized counter (vcount.split_rows) needs only one
    quad-grid anchoring."""
    nz = np.nonzero(ix)[0]
    if not len(nz):
        return 0, 0
    last = int(nz[-1]) + 1
    rzero_start = (last + 3) & ~3    # quad-align
    # scan backwards in quads while all |v| <= 1
    c1_start = rzero_start
    while c1_start >= 4 and np.abs(ix[c1_start - 4:c1_start]).max() <= 1:
        c1_start -= 4
    big_values = c1_start // 2
    count1 = (rzero_start - c1_start) // 4
    return big_values, count1


def _regions_long(bv2: int, sample_rate: int) -> tuple[int, int, int, int]:
    """(region0_count, region1_count, r1_line, r2_line) for long blocks —
    split the big-values region ~1/3, 5/12 by scalefactor bands [Annex C]."""
    bands = LONG[sample_rate]
    bidx = int(np.searchsorted(bands, bv2, "left"))
    r0c = max(min(bidx * 1 // 3, 15), 0)
    r1c = max(min(bidx - r0c - 1, 7), 0)
    if r0c + 1 + r1c + 1 > 22:
        r1c = 22 - r0c - 2
    r1 = int(bands[min(r0c + 1, 22)])
    r2 = int(bands[min(r0c + 1 + r1c + 1, 22)])
    return r0c, r1c, min(r1, bv2), min(r2, bv2)


def _encode_pairs(w: BitWriter, pairs: np.ndarray, tid: int):
    """Vectorized pair emission: per pair the fields are (code,
    [linbits-escape x], [sign x], [linbits-escape y], [sign y]) —
    assembled as a [N, 5] value/length matrix and appended in one
    put_array call (zero-length fields vanish)."""
    if tid == 0 or not len(pairs):
        return
    lens, codes, xl, yl, linbits = ht.table_arrays(tid)
    lut_l = np.asarray(lens).reshape(xl, yl)
    lut_c = np.asarray(codes).reshape(xl, yl)
    x = pairs[:, 0].astype(np.int64)
    y = pairs[:, 1].astype(np.int64)
    ax, ay = np.abs(x), np.abs(y)
    cx, cy = np.minimum(ax, xl - 1), np.minimum(ay, yl - 1)
    N = len(pairs)
    V = np.zeros((N, 5), np.int64)
    L = np.zeros((N, 5), np.int64)
    V[:, 0] = lut_c[cx, cy]
    L[:, 0] = lut_l[cx, cy]
    if xl == 16:
        esc_a = ax >= 15
        V[:, 1] = np.where(esc_a, ax - 15, 0)
        L[:, 1] = np.where(esc_a, linbits, 0)
        esc_b = ay >= 15
        V[:, 3] = np.where(esc_b, ay - 15, 0)
        L[:, 3] = np.where(esc_b, linbits, 0)
    L[:, 2] = ax > 0
    V[:, 2] = x < 0
    L[:, 4] = ay > 0
    V[:, 4] = y < 0
    w.put_array(V.ravel(), L.ravel())


def pick_scalefac_compress(long_sf: np.ndarray) -> int:
    """Smallest-cost scalefac_compress whose slen1/slen2 fit the long
    scalefactors (sfb 0-10 / 11-20) [§2.4.2.7]."""
    need1 = int(long_sf[:11].max(initial=0)).bit_length()
    need2 = int(long_sf[11:21].max(initial=0)).bit_length()
    best, cost = 0, 1 << 30
    for i in range(16):
        s1, s2 = int(SLEN1[i]), int(SLEN2[i])
        if s1 >= need1 and s2 >= need2:
            c = 11 * s1 + 10 * s2
            if c < cost:
                best, cost = i, c
    return best


def scalefac_bits(sfc: int) -> int:
    return 11 * int(SLEN1[sfc]) + 10 * int(SLEN2[sfc])


def pick_scalefac_compress_short(short_sf: np.ndarray) -> int:
    """Smallest-cost scalefac_compress for short-block scalefactors
    short_sf [3 windows, 12 bands]: slen1 covers sfb 0-5, slen2 covers
    sfb 6-11, each transmitted for all 3 windows [§2.4.2.7]."""
    need1 = int(short_sf[:, :6].max(initial=0)).bit_length()
    need2 = int(short_sf[:, 6:12].max(initial=0)).bit_length()
    best, cost = 0, 1 << 30
    for i in range(16):
        s1, s2 = int(SLEN1[i]), int(SLEN2[i])
        if s1 >= need1 and s2 >= need2:
            c = 18 * (s1 + s2)
            if c < cost:
                best, cost = i, c
    return best


def scalefac_bits_short(sfc: int) -> int:
    return 18 * (int(SLEN1[sfc]) + int(SLEN2[sfc]))

# largest transmittable short scalefactor per band (slen1 max 4 bits for
# sfb 0-5, slen2 max 3 bits for sfb 6-11)
SHORT_SF_CAP = np.array([15] * 6 + [7] * 6, np.int32)


def encode_granule(ix: np.ndarray, gg: int, sample_rate: int,
                   block_type: int = 0,
                   long_sf: np.ndarray | None = None,
                   short_sf: np.ndarray | None = None,
                   subblock_gain: tuple = (0, 0, 0),
                   tsel: tuple | None = None,
                   c1table: int | None = None) -> CodedGranule:
    """Entropy-code one granule-channel's quantized spectrum (long or
    window-switched block). long_sf / short_sf [3,12]: optional
    transmitted scalefactors (from the outer distortion loop);
    subblock_gain: per-window gain for short blocks; tsel/c1table:
    precomputed region table selections (from vcount — identical to
    the best_table search here) to skip the per-region re-search."""
    g = CodedGranule(global_gain=gg, block_type=block_type,
                     window_switching=1 if block_type else 0,
                     subblock_gain=tuple(int(s) for s in subblock_gain))
    bv, c1n = split_spectrum(ix)
    g.big_values = bv
    bv2 = bv * 2
    w = BitWriter()
    # long scalefactor layout applies to block types 0/1/3 (start/stop
    # granules keep the 576-line long spectrum and long sfb partition)
    if long_sf is not None and block_type != 2 and long_sf.any():
        g.scalefac_compress = pick_scalefac_compress(long_sf)
        s1, s2 = int(SLEN1[g.scalefac_compress]), int(SLEN2[g.scalefac_compress])
        for b in range(11):
            w.put(int(long_sf[b]), s1)
        for b in range(11, 21):
            w.put(int(long_sf[b]), s2)
    if short_sf is not None and block_type == 2 and short_sf.any():
        # non-mixed short order: sfb-major, window-minor [§2.4.2.7]
        g.scalefac_compress = pick_scalefac_compress_short(short_sf)
        s1, s2 = int(SLEN1[g.scalefac_compress]), int(SLEN2[g.scalefac_compress])
        for b in range(6):
            for win in range(3):
                w.put(int(short_sf[win, b]), s1)
        for b in range(6, 12):
            for win in range(3):
                w.put(int(short_sf[win, b]), s2)
    if g.window_switching:
        # fixed split [§2.4.2.7]
        r1 = min(3 * 12 if block_type == 2 else int(LONG[sample_rate][8]), bv2)
        if tsel is not None:
            t0, t1 = int(tsel[0]), int(tsel[1])
        else:
            t0, _ = best_table(ix[:r1].reshape(-1, 2))
            t1, _ = best_table(ix[r1:bv2].reshape(-1, 2))
        g.table_select = (t0, t1, 0)
        g.region0_count = 8 if block_type == 2 else 7
        g.region1_count = 20 - g.region0_count
        _encode_pairs(w, ix[:r1].reshape(-1, 2), t0)
        _encode_pairs(w, ix[r1:bv2].reshape(-1, 2), t1)
    else:
        r0c, r1c, r1, r2 = _regions_long(bv2, sample_rate)
        g.region0_count, g.region1_count = r0c, r1c
        if tsel is not None:
            t0, t1, t2 = (int(t) for t in tsel)
        else:
            t0, _ = best_table(ix[:r1].reshape(-1, 2))
            t1, _ = best_table(ix[r1:r2].reshape(-1, 2))
            t2, _ = best_table(ix[r2:bv2].reshape(-1, 2))
        g.table_select = (t0, t1, t2)
        for lo, hi, t in ((0, r1, t0), (r1, r2, t1), (r2, bv2, t2)):
            _encode_pairs(w, ix[lo:hi].reshape(-1, 2), t)
    # count1
    quads = ix[bv2: bv2 + 4 * c1n].reshape(-1, 4)
    if c1table is not None:
        g.count1table_select = int(c1table)
    else:
        ba = count1_bits(quads, 0)
        bb = count1_bits(quads, 1)
        g.count1table_select = 0 if ba <= bb else 1
    if len(quads):
        q = np.abs(quads.astype(np.int64))
        idx = (q[:, 0] << 3) | (q[:, 1] << 2) | (q[:, 2] << 1) | q[:, 3]
        V = np.zeros((len(quads), 5), np.int64)
        L = np.zeros((len(quads), 5), np.int64)
        if g.count1table_select == 0:
            V[:, 0] = np.asarray(ht.COUNT1A_CODES)[idx]
            L[:, 0] = np.asarray(ht.COUNT1A_LENS)[idx]
        else:
            V[:, 0] = 15 - idx
            L[:, 0] = 4
        L[:, 1:] = q > 0
        V[:, 1:] = quads < 0
        w.put_array(V.ravel(), L.ravel())
    g.bits = w
    g.part2_3_length = len(w)  # includes part2 (scalefactors), if any
    return g


def count_granule_bits(ix: np.ndarray, sample_rate: int,
                       block_type: int = 0) -> int:
    """Fast bit count for the rate loop (no bitstream materialized)."""
    bv, c1n = split_spectrum(ix)
    bv2 = bv * 2
    total = 0
    if block_type:
        r1 = min(36, bv2)
        total += best_table(ix[:r1].reshape(-1, 2))[1]
        total += best_table(ix[r1:bv2].reshape(-1, 2))[1]
    else:
        _r0c, _r1c, r1, r2 = _regions_long(bv2, sample_rate)
        for lo, hi in ((0, r1), (r1, r2), (r2, bv2)):
            total += best_table(ix[lo:hi].reshape(-1, 2))[1]
    quads = ix[bv2: bv2 + 4 * c1n].reshape(-1, 4)
    total += min(count1_bits(quads, 0), count1_bits(quads, 1))
    return total
