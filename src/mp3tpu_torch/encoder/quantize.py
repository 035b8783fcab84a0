"""Quantization rate loop (SURVEY.md E4) — ISO 11172-3 Annex C.1.5.4.

Inner (rate) loop only in v1: scalefactors stay zero and global_gain is
searched so the Huffman-coded granule fits its bit budget. The outer
(distortion) loop hooks in via the psymodel's per-band allowed noise
(see psymodel.py) by raising scalefactors — wired when xmin shaping is
enabled.

Copy of mp3tpu.encoder.quantize, kept in the port so that it imports nothing of
the JAX package; the code is the same.
"""
from __future__ import annotations

import numpy as np

from ..tables.sfb import LONG
from .huffcode import count_granule_bits, pick_scalefac_compress, scalefac_bits

MAGIC = 0.4054   # x^(3/4) rounding offset (Annex C reference value)
IX_MAX = 8206    # largest representable |ix| (escape 15 + 2^13 - 1)


def sf_jump_default() -> bool:
    """Outer-loop scalefactor JUMP stepping (docs/rate_loop_notes.md):
    instead of Annex C's +1 step per over-distorted band per iteration,
    step by half the band's log2 noise/allowed gap. One sf step halves
    quantization-noise power, so the needed amplification is
    ~log2(dist/xmin) steps; jumping half the remaining gap converges in
    O(log log) iterations and cannot overshoot in that noise model
    (k <= need/2). Measured: long-block p50 11 -> 3 outer iterations on
    the bench fixture, NMR within noise of +1 stepping. One flag for
    ALL implementations (scalar / numpy vloop / device vloop) so the
    lockstep contracts stay exact; MP3TPU_SF_JUMP=0 restores +1."""
    import os
    return os.environ.get("MP3TPU_SF_JUMP", "1") != "0"


def sf_jump_steps(dist, xmin, headroom):
    """Per-band jump size, shared by the host implementations: k in
    [1, headroom], k = floor(0.5 * log2(dist / xmin)) on the over bands
    (callers mask; ratios are clipped so zero/inf lanes stay finite)."""
    ratio = np.clip(np.asarray(dist, np.float64)
                    / np.maximum(np.asarray(xmin, np.float64), 1e-300),
                    1.0, 2.0 ** 60)
    k = np.floor(0.5 * np.log2(ratio)).astype(np.int64)
    return np.clip(k, 1, np.maximum(np.asarray(headroom, np.int64), 1))


def quantize(xr: np.ndarray, global_gain: int,
             p34: np.ndarray | None = None) -> np.ndarray:
    """xr [576] float -> ix [576] int32 with step 2^((gg-210)/4).

    p34 optionally carries the precomputed |xr|^0.75 (the power law is
    hoisted out of the rate loop: (|xr|*s)^0.75 == |xr|^0.75 * s^0.75 in
    the reals; in float64 the two evaluations can differ in the last ulp
    and flip floor() at a quantization boundary, so hoisted vs unhoisted
    output is equivalent-rate valid MP3, not guaranteed bit-identical).
    """
    if p34 is None:
        p34 = np.abs(xr) ** 0.75
    ix = np.floor(p34 * 2.0 ** (-0.75 * (global_gain - 210) / 4.0) + MAGIC
                  ).astype(np.int64)
    return (np.sign(xr) * ix).astype(np.int32)


# gg search window for outer-loop iterations >= 2: the fitting gg moves
# little between outer iterations (~2 gg steps per scalefactor step), so
# after the first full-range bisection the search covers
# [gg_lo, gg_lo+31] (5 count steps on device instead of 8); a
# window-exhausted row advances its bound and retries next iteration
# without amplifying. Canonical constant — vloop.py and vloop_device.py
# import it so all three loop stacks stay in lockstep.
GG_WINDOW = 32


def inner_rate_loop(xr: np.ndarray, budget_bits: int, sample_rate: int,
                    block_type: int = 0, lo: int = 0, window: int | None = None):
    """Find the smallest global_gain whose coded size fits budget_bits.

    Returns (ix, global_gain) — bisection over [lo', 255] (monotone in
    gg), where lo' is `lo` raised by the |ix| <= IX_MAX closed bound.
    With `window`, the search covers only [lo', lo'+window-1] and the
    return is (ix, gg, capped, next_lo): capped = window exhausted
    below 255 with no fit (caller retries from next_lo = lo'+window)."""
    p34 = np.abs(xr) ** 0.75
    # quick lower bound: max |ix| must be <= IX_MAX
    amax = np.abs(xr).max()
    if amax > 0:
        while (amax * 2.0 ** (-(lo - 210) / 4.0)) ** 0.75 > IX_MAX and lo < 255:
            lo += 4
    hi = 255 if window is None else min(lo + window - 1, 255)
    hi0 = hi
    next_lo = min(lo + (window or 0), 255)
    best = None
    while lo <= hi:
        mid = (lo + hi) // 2
        ix = quantize(xr, mid, p34)
        if np.abs(ix).max() > IX_MAX:
            lo = mid + 1
            continue
        bits = count_granule_bits(ix, sample_rate, block_type)
        if bits <= budget_bits:
            best = (ix, mid)
            hi = mid - 1
        else:
            lo = mid + 1
    if best is None:
        best = (np.zeros(576, np.int32), 210)
        if window is not None:
            return best[0], best[1], hi0 < 255, next_lo
    if window is not None:
        return best[0], best[1], False, next_lo
    return best


def outer_distortion_loop(xr: np.ndarray, xmin: np.ndarray, budget_bits: int,
                          sample_rate: int, max_iters: int = 16,
                          block_type: int = 0, jump: bool | None = None):
    """Outer (distortion) + inner (rate) loops [Annex C.1.5.4]: raise
    per-band scalefactors on bands whose quantization noise exceeds the
    psymodel's allowed distortion, then re-run the rate loop, until
    bands fit or scalefactors saturate. Step size: +1 (Annex C) or the
    gap-halving jump (sf_jump_default; the amplification per line is
    always recomputed as 2^(sf/2) from the TOTAL scalefactor, matching
    the device loop's formulation exactly).

    Long-layout blocks (block_type 0, 1 = start, 3 = stop — start/stop
    granules keep the 576-line long spectrum and long scalefactor
    bands; only the Huffman region split differs, which the bit counter
    handles via block_type). Returns (ix, gg, long_sf[21]).
    """
    if jump is None:
        jump = sf_jump_default()
    bands = LONG[sample_rate]
    sf = np.zeros(21, np.int32)
    sf_cap = np.array([15] * 11 + [7] * 10, np.int32)  # slen1/slen2 maxima
    amp = np.ones(576)
    best = None
    gg_lo = 0
    first = True
    for _ in range(max_iters):
        sfc = pick_scalefac_compress(sf)
        budget = budget_bits - scalefac_bits(sfc)
        if budget < 0:
            break
        if first:
            ix, gg = inner_rate_loop(xr * amp, budget, sample_rate,
                                     block_type, lo=gg_lo)
            first = False
        else:
            ix, gg, capped, next_lo = inner_rate_loop(
                xr * amp, budget, sample_rate, block_type, lo=gg_lo,
                window=GG_WINDOW)
            if capped:       # window exhausted: retry from next_lo,
                gg_lo = next_lo          # unamplified (see GG_WINDOW)
                continue
        gg_lo = gg
        deq = (np.abs(ix).astype(np.float64) ** (4.0 / 3.0)) *             2.0 ** ((gg - 210) / 4.0) / amp
        err = (np.abs(xr) - deq) ** 2
        dist = np.array([err[bands[b]:bands[b + 1]].sum() for b in range(21)])
        best = (ix, gg, sf.copy())
        over = (dist > xmin[:21]) & (sf < sf_cap)
        if not over.any():
            break
        if jump:
            k = sf_jump_steps(dist, xmin[:21], sf_cap - sf)
            sf[over] += k[over].astype(sf.dtype)
        else:
            sf[over] += 1
        for b in np.nonzero(over)[0]:
            amp[bands[b]:bands[b + 1]] = 2.0 ** (sf[b] / 2.0)
    if best is None:
        ix, gg = inner_rate_loop(xr, budget_bits, sample_rate, block_type)
        return ix, gg, np.zeros(21, np.int32)
    return best


def outer_distortion_loop_short(xr: np.ndarray, xmin: np.ndarray,
                                budget_bits: int, sample_rate: int,
                                max_iters: int = 12,
                                jump: bool | None = None):
    """Outer loop for short (window-switched) blocks [Annex C.1.5.4]:
    per-(window, band) scalefactors in sqrt(2) steps; when a window's
    scalefactors hit the slen cap, escalate subblock_gain (one step =
    4x amplification = 4 scalefactor steps) and fold the scalefactors
    back down.

    xr: transmitted-order spectrum [576]; xmin: allowed noise energy
    per (window, band) [3, 12]. Returns (ix, gg, short_sf[3,12], sbg[3]).
    """
    from ..tables import maps as tmaps
    from .huffcode import (SHORT_SF_CAP, pick_scalefac_compress_short,
                           scalefac_bits_short)
    if jump is None:
        jump = sf_jump_default()
    bm = tmaps.band_map(sample_rate, tmaps.FLAVOR_SHORT)
    wline = (bm - 22) // 13          # window of each transmitted line
    sline = (bm - 22) % 13           # short sfb of each line
    flat = wline * 13 + sline        # (window, band) slot per line, 0..38
    sf = np.zeros((3, 12), np.int32)
    sbg = np.zeros(3, np.int32)
    best = None
    gg_lo = 0
    first = True
    for _ in range(max_iters):
        sfc = pick_scalefac_compress_short(sf)
        budget = budget_bits - scalefac_bits_short(sfc)
        if budget < 0:
            break
        # encoder amplification = exact inverse of the decoder's
        # 2^(-(8*sbg + 2*sf)/4) quarter-step exponent (scalefac_scale=0)
        q = 8 * sbg[:, None] + 2 * np.concatenate(
            [sf, np.zeros((3, 1), np.int32)], axis=1)      # [3, 13]
        amp = 2.0 ** (q[wline, sline] / 4.0)               # [576]
        if first:
            ix, gg = inner_rate_loop(xr * amp, budget, sample_rate, 2,
                                     lo=gg_lo)
            first = False
        else:
            ix, gg, capped, next_lo = inner_rate_loop(
                xr * amp, budget, sample_rate, 2, lo=gg_lo,
                window=GG_WINDOW)
            if capped:       # window exhausted: retry, unamplified
                gg_lo = next_lo
                continue
        gg_lo = gg
        deq = (np.abs(ix).astype(np.float64) ** (4.0 / 3.0)) * \
            2.0 ** ((gg - 210) / 4.0) / amp
        err = (np.abs(xr) - deq) ** 2
        dist = np.bincount(flat, weights=err, minlength=39).reshape(3, 13)
        best = (ix, gg, sf.copy(), sbg.copy())
        over = dist[:, :12] > xmin
        headroom = (sf < SHORT_SF_CAP) | (sbg[:, None] < 7)
        over &= headroom
        if not over.any():
            break
        if jump:
            # jump, but at most one step past the slen cap: the cap
            # overshoot is what escalates subblock_gain (one sbg step =
            # 4 sf steps), and that escalation stays one-per-iteration
            k = sf_jump_steps(dist[:, :12], xmin, SHORT_SF_CAP + 1 - sf)
            sf[over] += k[over].astype(sf.dtype)
        else:
            sf[over] += 1
        for w in range(3):
            if (sf[w] > SHORT_SF_CAP).any():
                if sbg[w] < 7:
                    sbg[w] += 1
                    sf[w] = np.maximum(sf[w] - 4, 0)
                sf[w] = np.minimum(sf[w], SHORT_SF_CAP)
    if best is None:
        ix, gg = inner_rate_loop(xr, budget_bits, sample_rate, 2)
        return ix, gg, np.zeros((3, 12), np.int32), np.zeros(3, np.int32)
    return best
