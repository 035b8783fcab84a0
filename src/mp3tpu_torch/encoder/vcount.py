"""Vectorized multi-granule Huffman bit counting (SURVEY.md E4/E5,
§7.5 hard-part 5: "batch the per-iteration bit-count/distortion math").

`count_bits_rows` evaluates the exact quantity `huffcode.count_granule_bits`
computes — minimal coded bits over region splits, per-region best table,
count1 A/B — for R quantized spectra at once, as dense numpy ops:

  * per-pair code lengths for ALL tables via one [T, 256] LUT gather;
    tables that cannot represent a pair carry a huge penalty, so the
    per-region min over tables implicitly performs table selection
    (including the all-zero table 0 and linbits escape selection);
  * region boundary arithmetic (rzero / count1 / big_values split and
    the long-block 1/3-5/12 sfb split) as vector index math;
  * region sums as cumsum + gather, so the cost per candidate row is
    ~288*T LUT reads with zero Python per-pair work.

The scalar `count_granule_bits` stays as the reference; tests assert
row-for-row equality on fixture and random spectra.

Copy of mp3tpu.encoder.vcount, kept in the port so that it imports nothing of
the JAX package; the code is the same.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..tables import huffman as ht
from ..tables.sfb import LONG

BIG = 1 << 26   # "cannot code" penalty; sums of valid codes stay far below

# table ids in evaluation order: 0, plain, escape (A then B families)
_PLAIN = (1, 2, 3, 5, 6, 7, 8, 9, 10, 11, 12, 13, 15)
_ESC = (16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31)
TABLE_IDS = (0,) + _PLAIN + _ESC
N_PLAIN = 1 + len(_PLAIN)      # rows 0..13 of the LUT stack (incl. table 0)


@lru_cache(maxsize=None)
def _hist_matrix():
    """(M [289, T+1] float64, ov_pen [14, T] float64).

    M maps a 17x17 clamped-pair histogram (bin = min(a,16)*17+min(b,16);
    16 means ">15") to per-table region bits:
      * plain tables: code length per bin, BIG where uncodable (beyond
        xl/yl, or any operand >15);
      * escape tables: length at (min15, min15) + linbits per operand
        that is >=15;
      * table 0: BIG on any nonzero bin (codes only silence);
      * last column: sign bits (count of nonzero operands) — shared by
        all tables, added once.
    ov_pen[L, t] = BIG where an operand overflow of bit-length L
    (operand-15 in [2^(L-1), 2^L-1]) cannot ride table t's linbits.
    All entries are exact small ints; float64 keeps the matmul in BLAS
    (sums stay far below 2^53)."""
    T = len(TABLE_IDS)
    M = np.zeros((289, T + 1), np.float64)
    ii = np.arange(17)
    ia = np.repeat(ii, 17)          # bin -> clamped a
    ib = np.tile(ii, 17)            # bin -> clamped b
    for col, tid in enumerate(TABLE_IDS):
        if tid == 0:
            M[:, col] = ((ia > 0) | (ib > 0)) * BIG
            continue
        lens, _codes, xl, yl, lb = ht.table_arrays(tid)
        lut = np.full((17, 17), BIG, np.float64)
        lut[:xl, :yl] = np.asarray(lens, np.float64).reshape(xl, yl)
        if col >= N_PLAIN:
            # escape: clamp operands to 15 for the base code, add
            # linbits per operand >= 15 (bins 15 and 16)
            base = lut[np.minimum(ia, 15), np.minimum(ib, 15)]
            M[:, col] = base + lb * ((ia >= 15).astype(np.float64)
                                     + (ib >= 15))
        else:
            v = lut[np.minimum(ia, 16), np.minimum(ib, 16)]
            v = np.where((ia > 15) | (ib > 15), BIG, v)
            M[:, col] = np.minimum(v, BIG)
    M[:, T] = (ia > 0).astype(np.float64) + (ib > 0)   # sign bits
    ov_pen = np.zeros((15, T), np.float64)
    for col, tid in enumerate(TABLE_IDS):
        lb = ht.TABLE_INFO[tid][3] if (tid and col >= N_PLAIN) else 0
        for L in range(1, 15):
            # overflow operand of bit-length L needs linbits >= L;
            # bucket 14 = ">13 bits", uncodable by every table (the rate
            # loop rejects such rows via the IX_MAX check, but candidate
            # quantizations are counted before that check)
            if col < N_PLAIN or L > lb:
                ov_pen[L, col] = BIG
    # f32 split: code lengths (<=19, sums exact in f32) and a 0/1
    # invalid-bin indicator; BIG is applied after the matmuls, keeping
    # both GEMMs in fast f32 while staying bit-exact
    M_len = np.where(M >= BIG, 0.0, M).astype(np.float32)
    M_bad = (M[:, :T] >= BIG).astype(np.float32)
    ov_bad = (ov_pen >= BIG).astype(np.float32)
    return M, ov_pen, M_len, M_bad, ov_bad


_C1A = np.asarray(ht.COUNT1A_LENS, np.int32)
_POP4 = np.array([bin(i).count("1") for i in range(16)], np.int32)
_C1A_SIG = _C1A + _POP4        # table-A length + sign bits per quad
_C1B_SIG = 4 + _POP4           # table-B length + sign bits per quad


@lru_cache(maxsize=None)
def _long_region_tables(sample_rate: int):
    """Precomputed (r1_pairs, r2_pairs) indexed by bv2//2 (0..288) —
    vectorizes huffcode._regions_long (pure function of bv2)."""
    bands = LONG[sample_rate]
    r1p = np.zeros(289, np.int64)
    r2p = np.zeros(289, np.int64)
    for bvp in range(289):
        bv2 = bvp * 2
        bidx = int(np.searchsorted(bands, bv2, "left"))
        r0c = max(min(bidx // 3, 15), 0)
        r1c = max(min(bidx - r0c - 1, 7), 0)
        if r0c + 1 + r1c + 1 > 22:
            r1c = 22 - r0c - 2
        r1 = int(bands[min(r0c + 1, 22)])
        r2 = int(bands[min(r0c + 1 + r1c + 1, 22)])
        r1p[bvp] = min(r1, bv2) // 2
        r2p[bvp] = min(r2, bv2) // 2
    return r1p, r2p


@lru_cache(maxsize=None)
def _long_region_counts(sample_rate: int):
    """(region0_count, region1_count) by bv2//2 — for emission reuse."""
    bands = LONG[sample_rate]
    r0 = np.zeros(289, np.int64)
    r1 = np.zeros(289, np.int64)
    for bvp in range(289):
        bidx = int(np.searchsorted(bands, bvp * 2, "left"))
        r0c = max(min(bidx // 3, 15), 0)
        r1c = max(min(bidx - r0c - 1, 7), 0)
        if r0c + 1 + r1c + 1 > 22:
            r1c = 22 - r0c - 2
        r0[bvp] = r0c
        r1[bvp] = r1c
    return r0, r1


def split_rows(ix: np.ndarray):
    """Vectorized huffcode.split_spectrum over rows.

    ix: [R, 576] int. Returns (bv_pairs [R], c1_quads [R]) — identical
    to split_spectrum(row) for every row. The quad-grid anchoring
    (rzero rounded up to a multiple of 4 lines) makes bv always even."""
    a = np.abs(ix[:, 0::2])
    b = np.abs(ix[:, 1::2])
    nz = (a | b) > 0                      # pair has any nonzero
    big = np.maximum(a, b) > 1            # pair has |v| > 1
    anynz = nz.any(1)
    rzp = np.where(anynz, 288 - nz[:, ::-1].argmax(1), 0)     # pairs used
    rzp = rzp + (rzp & 1)                 # quad-align (even pair count)
    anybig = big.any(1)
    bigp = np.where(anybig, 288 - big[:, ::-1].argmax(1), 0)  # pairs w/ big
    k = (rzp - bigp) // 2                 # trailing all-small quads
    bv = rzp - 2 * k
    return bv, k


def count_bits_rows(ix: np.ndarray, sample_rate: int,
                    block_type: int = 0) -> np.ndarray:
    """bits [R] == [count_granule_bits(row, sample_rate, block_type)]."""
    bits, _sel = count_bits_rows_full(ix, sample_rate, block_type)
    return bits


@lru_cache(maxsize=None)
def _bitlen_lut():
    v = np.arange(8192)
    out = np.zeros(8192, np.int64)
    out[1:] = np.floor(np.log2(v[1:])).astype(np.int64) + 1
    return out


def count_bits_rows_full(ix: np.ndarray, sample_rate: int,
                         block_type: int = 0):
    """As count_bits_rows, additionally returning the selection dict
    (big_values, count1 quads, per-region best tables, count1 table)
    for emission reuse.

    Core trick: region bit sums are order-independent, so each (row,
    region) reduces to a 17x17 clamped-pair histogram (np.bincount) and
    ONE [R*3, 289] @ [289, T+1] float64 matmul yields every table's
    region bits + sign counts; escape-overflow validity rides a second
    14-bucket magnitude histogram. ~10 us/row instead of ~560 us for
    the scalar scan."""
    ix = np.asarray(ix)
    R = ix.shape[0]
    _M, _ovp, M_len, M_bad, ov_bad = _hist_matrix()
    T = len(TABLE_IDS)
    a = np.abs(ix[:, 0::2]).astype(np.int32)
    b = np.abs(ix[:, 1::2]).astype(np.int32)

    bv, k = split_rows(ix)
    bv2p = bv                              # big-values region in pairs
    if block_type:
        r1p = np.minimum(18, bv2p)         # 36 lines fixed split
        r2p = bv2p                         # (two regions only)
    else:
        t1, t2 = _long_region_tables(sample_rate)
        r1p = t1[bv2p]
        r2p = t2[bv2p]

    # region id per pair: 0/1/2 inside big values, 3 beyond (dropped)
    pidx = np.arange(288, dtype=np.int32)
    rid = ((pidx >= r1p[:, None]).astype(np.int32)
           + (pidx >= r2p[:, None]) + (pidx >= bv2p[:, None]))
    base = np.arange(R, dtype=np.int32)[:, None] * 4 + rid
    bins = np.minimum(a, 16) * 17 + np.minimum(b, 16)
    hist = np.bincount((base * 289 + bins).ravel(),
                       minlength=R * 4 * 289).reshape(R, 4, 289)
    h3 = hist[:, :3].reshape(R * 3, 289).astype(np.float32)
    bits_t = h3 @ M_len                    # exact: lengths <= 19
    bad = h3 @ M_bad
    # escape overflow validity: bucket pairs by bit_length(max-15);
    # skipped entirely when no pair escapes (the common case at the
    # rate loop's converged gains)
    mxab = np.maximum(a, b)
    if int(mxab.max(initial=0)) > 15:
        mx15 = np.maximum(mxab - 15, 0)
        ovL = np.where(mx15 > 8191, 14, _bitlen_lut()[np.minimum(mx15, 8191)])
        histov = np.bincount((base * 15 + ovL).ravel(),
                             minlength=R * 4 * 15).reshape(R, 4, 15)
        bad = bad + histov[:, :3].reshape(R * 3, 15).astype(np.float32) @ ov_bad
    reg = bits_t[:, :T].astype(np.float64) + (bad[:, :T] > 0) * float(BIG)
    selr = reg.argmin(1)                   # first minimum: scalar order
    regmin = reg[np.arange(R * 3), selr].reshape(R, 3)
    signs = bits_t[:, T].reshape(R, 3)
    total = np.rint(regmin.sum(1) + signs.sum(1).astype(np.float64)
                    ).astype(np.int64)
    selr = selr.reshape(R, 3)
    sel0, sel1, sel2 = selr[:, 0], selr[:, 1], selr[:, 2]
    rows = np.arange(R)

    # ---- count1: k quads on the fixed line grid (bv is always even —
    # split_rows quad-aligns rzero), one cumsum per table
    nzq = (ix != 0).reshape(R, 144, 4)               # count1 values are 0/1
    idxq = ((nzq[..., 0] << 3) | (nzq[..., 1] << 2)
            | (nzq[..., 2] << 1) | nzq[..., 3]).astype(np.int32)
    csa = np.zeros((R, 145), np.int64)
    csb = np.zeros((R, 145), np.int64)
    np.cumsum(_C1A_SIG[idxq], axis=1, out=csa[:, 1:])   # len+signs fused
    np.cumsum(_C1B_SIG[idxq], axis=1, out=csb[:, 1:])
    q0 = bv // 2
    q1 = q0 + k
    ca = csa[rows, q1] - csa[rows, q0]
    cb = csb[rows, q1] - csb[rows, q0]
    c1sel = (ca > cb).astype(np.int64)
    total += np.minimum(ca, cb)

    sel = {
        "bv": bv, "c1": k,
        "t0": np.asarray(TABLE_IDS)[sel0],
        "t1": np.asarray(TABLE_IDS)[sel1],
        "t2": np.asarray(TABLE_IDS)[sel2],
        "c1table": c1sel,
        "r1p": r1p, "r2p": r2p,
    }
    return total, sel
