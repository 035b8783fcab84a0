"""Lockstep (row-parallel) rate & distortion loops (SURVEY.md E4,
§7.5 hard-part 5: loop control on host, per-iteration math batched).

Mirrors quantize.inner_rate_loop / outer_distortion_loop(_short)
exactly, but for R granule-channels at once: every bisection step
quantizes and bit-counts all rows in one vcount call, every outer
iteration amplifies all rows' offending bands together. Rows converge
independently (masked); the per-row decisions are identical to the
scalar loops (same bisection order, same amplification policy), so a
row's (ix, gg, sf) equals the scalar result for the same inputs.

Copy of mp3tpu.encoder.vloop, kept in the port so that it imports nothing of
the JAX package; the code is the same.
"""
from __future__ import annotations

import numpy as np

from ..tables.sfb import LONG, SLEN1, SLEN2
from .quantize import (GG_WINDOW, IX_MAX, MAGIC, sf_jump_default,
                       sf_jump_steps)
from .vcount import count_bits_rows

_SLEN1 = np.asarray(SLEN1, np.int64)
_SLEN2 = np.asarray(SLEN2, np.int64)


def quantize_rows(p34: np.ndarray, sign: np.ndarray, gg: np.ndarray) -> np.ndarray:
    """Rows of quantize(): ix = sign * floor(p34 * 2^(-0.75(gg-210)/4) + MAGIC)."""
    scale = 2.0 ** (-0.75 * (gg[:, None] - 210) / 4.0)
    ix = np.floor(p34 * scale + MAGIC).astype(np.int64)
    return (sign * ix).astype(np.int32)


def inner_rate_rows(xr: np.ndarray, budgets: np.ndarray, sample_rate: int,
                    block_type: int = 0, lo: np.ndarray | None = None,
                    window: int | None = None):
    """Lockstep inner_rate_loop over rows.

    xr [R,576], budgets [R]. Returns (ix [R,576] int32, gg [R] int64);
    rows that never fit return (zeros, 210) like the scalar loop. With
    `window` (quantize.GG_WINDOW semantics), the bisection covers only
    [lo', lo'+window-1] and the return gains (capped [R] bool,
    next_lo [R]): capped rows exhausted a sub-255 window with no fit
    and should retry from next_lo without amplifying."""
    R = xr.shape[0]
    p34 = np.abs(xr) ** 0.75
    sign = np.sign(xr)
    lo = np.zeros(R, np.int64) if lo is None else lo.astype(np.int64).copy()
    amax = np.abs(xr).max(1)
    # quick lower bound (same +4 stepping as the scalar loop)
    pos = amax > 0
    while True:
        too_big = pos & ((amax * 2.0 ** (-(lo - 210) / 4.0)) ** 0.75 > IX_MAX) & (lo < 255)
        if not too_big.any():
            break
        lo[too_big] += 4
    if window is None:
        hi = np.full(R, 255, np.int64)
    else:
        hi = np.minimum(lo + (window - 1), 255)
    hi0 = hi.copy()
    next_lo = np.minimum(lo + (window or 0), 255)
    best_ix = np.zeros((R, 576), np.int32)
    best_gg = np.full(R, 210, np.int64)
    has_best = np.zeros(R, bool)
    while True:
        act = np.nonzero(lo <= hi)[0]      # compact: converged rows drop out
        if not len(act):
            break
        mid = (lo[act] + hi[act]) // 2
        ix = quantize_rows(p34[act], sign[act], mid)
        over = np.abs(ix).max(1) > IX_MAX
        bits = count_bits_rows(ix, sample_rate, block_type)
        fits = ~over & (bits <= budgets[act])
        fit_rows = act[fits]
        best_ix[fit_rows] = ix[fits]
        best_gg[fit_rows] = mid[fits]
        has_best[fit_rows] = True
        hi[fit_rows] = mid[fits] - 1
        lo[act[~fits]] = mid[~fits] + 1
    best_gg = np.where(has_best, best_gg, 210)
    best_ix[~has_best] = 0
    if window is not None:
        capped = ~has_best & (hi0 < 255)
        return best_ix, best_gg, capped, next_lo
    return best_ix, best_gg


def pick_sfc_rows(long_sf: np.ndarray) -> np.ndarray:
    """Vectorized pick_scalefac_compress: long_sf [R,21] -> sfc [R]."""
    need1 = np.zeros(len(long_sf), np.int64)
    need2 = np.zeros(len(long_sf), np.int64)
    m1 = long_sf[:, :11].max(1)
    m2 = long_sf[:, 11:21].max(1)
    for k in range(1, 5):
        need1[m1 >= (1 << (k - 1))] = k
        need2[m2 >= (1 << (k - 1))] = k
    cost = 11 * _SLEN1 + 10 * _SLEN2                       # [16]
    ok = (_SLEN1[None] >= need1[:, None]) & (_SLEN2[None] >= need2[:, None])
    c = np.where(ok, cost[None], 1 << 30)
    return c.argmin(1)


def pick_sfc_short_rows(short_sf: np.ndarray) -> np.ndarray:
    """Vectorized pick_scalefac_compress_short: short_sf [R,3,12] -> sfc."""
    need1 = np.zeros(len(short_sf), np.int64)
    need2 = np.zeros(len(short_sf), np.int64)
    m1 = short_sf[:, :, :6].max((1, 2))
    m2 = short_sf[:, :, 6:12].max((1, 2))
    for k in range(1, 5):
        need1[m1 >= (1 << (k - 1))] = k
        need2[m2 >= (1 << (k - 1))] = k
    cost = 18 * (_SLEN1 + _SLEN2)
    ok = (_SLEN1[None] >= need1[:, None]) & (_SLEN2[None] >= need2[:, None])
    c = np.where(ok, cost[None], 1 << 30)
    return c.argmin(1)


def outer_rows(xr: np.ndarray, xmin: np.ndarray, budget_bits: np.ndarray,
               sample_rate: int, max_iters: int = 16, block_type: int = 0,
               jump: bool | None = None):
    """Lockstep outer_distortion_loop (long-layout blocks: 0/1/3 —
    start/stop granules keep the long spectrum + long scalefactor
    bands; block_type only changes the counter's region split).

    xr [R,576], xmin [R,21], budget_bits [R].
    Returns (ix [R,576], gg [R], long_sf [R,21])."""
    if jump is None:
        jump = sf_jump_default()
    R = xr.shape[0]
    bands = LONG[sample_rate]
    edges = bands[:22]
    band_of_line = np.zeros(576, np.int64)
    for b in range(21):
        band_of_line[bands[b]:bands[b + 1]] = b
    band_of_line[bands[21]:] = 21          # beyond sfb20: never amplified
    sf = np.zeros((R, 21), np.int64)
    sf_cap = np.array([15] * 11 + [7] * 10, np.int64)
    amp = np.ones((R, 576))
    best_ix = np.zeros((R, 576), np.int32)
    best_gg = np.full(R, 210, np.int64)
    best_sf = np.zeros((R, 21), np.int64)
    has_best = np.zeros(R, bool)
    gg_lo = np.zeros(R, np.int64)
    done = np.zeros(R, bool)
    first = True
    for _ in range(max_iters):
        act = np.nonzero(~done)[0]         # compact: done rows drop out
        if not len(act):
            break
        sfc = pick_sfc_rows(sf[act])
        sfbits = 11 * _SLEN1[sfc] + 10 * _SLEN2[sfc]
        budget = budget_bits[act] - sfbits
        neg = budget < 0                   # scalar: break, keep best
        done[act[neg]] = True
        act = act[~neg]
        if not len(act):
            break
        budget = budget[~neg]
        if first:
            ix, gg = inner_rate_rows(xr[act] * amp[act], budget,
                                     sample_rate, block_type,
                                     lo=gg_lo[act])
            capped = np.zeros(len(act), bool)
            next_lo = gg
            first = False
        else:
            ix, gg, capped, next_lo = inner_rate_rows(
                xr[act] * amp[act], budget, sample_rate, block_type,
                lo=gg_lo[act], window=GG_WINDOW)
        # mirror the scalar loop exactly (gg_lo = gg, not max): after an
        # inner-loop no-fit (gg=210) the scalar bound RESETS, and a later
        # iteration may legitimately fit below the stale bound; a
        # window-capped row instead advances to next_lo and retries
        gg_lo[act] = np.where(capped, next_lo, gg)
        ncap = np.nonzero(~capped)[0]
        upd = act[ncap]
        best_ix[upd] = ix[ncap]
        best_gg[upd] = gg[ncap]
        best_sf[upd] = sf[upd]
        has_best[upd] = True
        deq = (np.abs(ix).astype(np.float64) ** (4.0 / 3.0)) * \
            2.0 ** ((gg[:, None] - 210) / 4.0) / amp[act]
        err = (np.abs(xr[act]) - deq) ** 2
        dist = np.add.reduceat(err, edges, axis=1)[:, :21]
        over = (dist > xmin[act]) & (sf[act] < sf_cap)
        over &= ~capped[:, None]
        done[act[~(over.any(1) | capped)]] = True
        sfa = sf[act]
        if jump:
            k = sf_jump_steps(dist, xmin[act], sf_cap[None] - sfa)
            sfa[over] += k[over]
        else:
            sfa[over] += 1
        sf[act] = sfa
        # amplification recomputed from the TOTAL scalefactor (2^(sf/2)
        # per line; band 21 never amplified) — the device formulation
        sf21 = np.concatenate([sfa, np.zeros((len(act), 1), sfa.dtype)], 1)
        amp[act] = 2.0 ** (sf21[:, band_of_line] / 2.0)
    # rows that never produced a best (budget < 0 on iter 0): scalar
    # falls back to the plain rate loop at full budget
    fb = ~has_best
    if fb.any():
        ixf, ggf = inner_rate_rows(xr[fb], budget_bits[fb], sample_rate,
                                   block_type)
        best_ix[fb] = ixf
        best_gg[fb] = ggf
        best_sf[fb] = 0
    return best_ix, best_gg, best_sf


SHORT_SF_CAP_V = np.array([15] * 6 + [7] * 6, np.int64)


def outer_rows_short(xr: np.ndarray, xmin: np.ndarray,
                     budget_bits: np.ndarray, sample_rate: int,
                     max_iters: int = 12, jump: bool | None = None):
    """Lockstep outer_distortion_loop_short.

    xr [R,576] transmitted order, xmin [R,3,12].
    Returns (ix, gg, short_sf [R,3,12], sbg [R,3])."""
    from ..tables import maps as tmaps
    if jump is None:
        jump = sf_jump_default()
    R = xr.shape[0]
    bm = tmaps.band_map(sample_rate, tmaps.FLAVOR_SHORT)
    wline = (bm - 22) // 13
    sline = (bm - 22) % 13
    flat = wline * 13 + sline
    # distortion via one [576, 39] indicator matmul
    ind = np.zeros((576, 39))
    ind[np.arange(576), np.minimum(flat, 38)] = 1.0
    sf = np.zeros((R, 3, 12), np.int64)
    sbg = np.zeros((R, 3), np.int64)
    best_ix = np.zeros((R, 576), np.int32)
    best_gg = np.full(R, 210, np.int64)
    best_sf = np.zeros((R, 3, 12), np.int64)
    best_sbg = np.zeros((R, 3), np.int64)
    has_best = np.zeros(R, bool)
    gg_lo = np.zeros(R, np.int64)
    done = np.zeros(R, bool)
    sf13 = np.zeros((R, 3, 13), np.int64)
    first = True
    for _ in range(max_iters):
        act = np.nonzero(~done)[0]
        if not len(act):
            break
        sfc = pick_sfc_short_rows(sf[act])
        sfbits = 18 * (_SLEN1[sfc] + _SLEN2[sfc])
        budget = budget_bits[act] - sfbits
        neg = budget < 0
        done[act[neg]] = True
        act = act[~neg]
        if not len(act):
            break
        budget = budget[~neg]
        sf13[act, :, :12] = sf[act]
        q = 8 * sbg[act, :, None] + 2 * sf13[act]           # [A,3,13]
        amp = 2.0 ** (q[:, wline, sline] / 4.0)             # [A,576]
        if first:
            ix, gg = inner_rate_rows(xr[act] * amp, budget,
                                     sample_rate, 2, lo=gg_lo[act])
            capped = np.zeros(len(act), bool)
            next_lo = gg
            first = False
        else:
            ix, gg, capped, next_lo = inner_rate_rows(
                xr[act] * amp, budget, sample_rate, 2, lo=gg_lo[act],
                window=GG_WINDOW)
        # mirror the scalar loop exactly (gg_lo = gg, not max) — see
        # outer_rows; window-capped rows advance and retry
        gg_lo[act] = np.where(capped, next_lo, gg)
        ncap = np.nonzero(~capped)[0]
        upd = act[ncap]
        best_ix[upd] = ix[ncap]
        best_gg[upd] = gg[ncap]
        best_sf[upd] = sf[upd]
        best_sbg[upd] = sbg[upd]
        has_best[upd] = True
        deq = (np.abs(ix).astype(np.float64) ** (4.0 / 3.0)) * \
            2.0 ** ((gg[:, None] - 210) / 4.0) / amp
        err = (np.abs(xr[act]) - deq) ** 2
        dist = (err @ ind).reshape(len(act), 3, 13)
        over = dist[:, :, :12] > xmin[act]
        over &= (sf[act] < SHORT_SF_CAP_V) | (sbg[act, :, None] < 7)
        over &= ~capped[:, None, None]
        done[act[~(over.reshape(len(act), -1).any(1) | capped)]] = True
        sfa = sf[act]
        if jump:
            # at most one step past the slen cap per iteration: the cap
            # overshoot is what escalates subblock_gain (see quantize)
            k = sf_jump_steps(dist[:, :, :12], xmin[act],
                              SHORT_SF_CAP_V + 1 - sfa)
            sfa[over] += k[over]
        else:
            sfa[over] += 1
        # windows whose scalefactors exceed the cap escalate subblock_gain
        exceed = (sfa > SHORT_SF_CAP_V).any(2)              # [A,3]
        sbga = sbg[act]
        bump = exceed & (sbga < 7)
        sbga[bump] += 1
        sfa[bump] = np.maximum(sfa[bump] - 4, 0)
        sfa[exceed] = np.minimum(sfa[exceed], SHORT_SF_CAP_V)
        sf[act] = sfa
        sbg[act] = sbga
    fb = ~has_best
    if fb.any():
        ixf, ggf = inner_rate_rows(xr[fb], budget_bits[fb], sample_rate, 2)
        best_ix[fb] = ixf
        best_gg[fb] = ggf
        best_sf[fb] = 0
        best_sbg[fb] = 0
    return best_ix, best_gg, best_sf, best_sbg
