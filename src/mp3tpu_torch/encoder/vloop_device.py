"""Device lockstep rate and distortion loops (SURVEY.md E4, §3.4).

Counterpart of mp3tpu.encoder.vloop_device. The batched encoder's
throughput core: the outer distortion loop and the inner rate bisection run
over blocks of granule-channel rows in lockstep, with per-row convergence
masks (bisection over gg in [0, 255] is at most 8 steps; the outer loop
stops when every row of the block has converged).

Division of labor (the lockstep invariant):
  * the DEVICE searches (global_gain, scalefactors, subblock_gain) in
    f32: approximate at quantization-boundary ulps against the f64 scalar
    reference (a half-step rounding choice, still a valid quantizer);
  * the DEVICE's final quantize at the chosen parameters IS the emitted
    spectrum, and its integer bit count and table selection are EXACT for
    that spectrum (integer tensors throughout, bit for bit the count of
    vcount and of the device emitter: tested). The bisection guarantee
    bits <= budget therefore transfers to emission directly: count == emit,
    the contract the reservoir replay relies on;
  * the HOST keeps all loop CONTROL (budgets, reservoir walks, overdraft
    guards: SURVEY.md §7.5-5).

The numpy vloop (scalar-exact) remains the reference and the default for
single-stream encode_pcm; encode_batch uses this module.

Bit counting mirrors vcount.count_bits_rows_full in integers: each pair's
clamped bin gathers its code length under every table from the [289, T+1]
table, a running sum over the pairs read at the region boundaries gives
the three regions' bits per table, and table validity comes from region
maxima (plain: max < xl; escape: overflow bit length <= linbits; table 0:
region all zero). Every choice among equal costs (the Huffman table of a
region, scalefac_compress) takes the lowest index by an explicit integer
key, so that the CPU, the card, this count and the emitter always agree.

Rows are processed in blocks sized for the device's memory (the per-pair
length gather is [T+1, R, 288] int16); a row's result does not depend on
the block it is in (tested).

On CUDA tensors the bisection (_inner_bisect) and the final count
(_count_rows) run in the hand-written kernel of csrc/rate_bisect.cu, one
launch a call, through kernels/rate_bisect.py, with the same results bit for
bit; the torch code here is their plain version, which CPU tensors run.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..kernels import rate_bisect
from ..transfer import HostCopy
from .quantize import GG_WINDOW, IX_MAX, MAGIC, sf_jump_default
from .tables import EncoderTables, band_sums, encoder_tables
from .vcount import TABLE_IDS

SPF = 576
# rows of one loop block by device type
ROW_BLOCK = {"cpu": 256, "cuda": 32768}
# measurement hook: run every outer iteration to max_iters instead of
# stopping once a block's rows have all converged (the same bytes; timed by
# chip_smoke.py --profile)
FIXED_DEPTH = False
# "cannot code" cost of a region under a table; real costs stay below 2^15
_INVALID = 1 << 20
# gg search window for outer-loop iterations >= 2: the fitting gg only moves
# a little per outer iteration (amplification rises in a few bands; about 2 gg
# steps per scalefactor step), so after the first full-range bisection the
# search runs over [gg_lo, gg_lo + 31] in 5 count steps instead of
# [gg_lo, 255] in 8. A window-exhausted row ("capped") advances its bound by
# the window and retries next iteration without amplifying: the same final
# semantics, implemented identically in quantize.py, vloop.py and here
# (canonical constant in quantize.GG_WINDOW).
_FULL_STEPS = 8      # log2(256): the bisection over [lo, 255]
_WINDOW_STEPS = 5    # ceil(log2(GG_WINDOW))
_TID = np.asarray(TABLE_IDS)


def row_block(device) -> int:
    return ROW_BLOCK[torch.device(device).type]


def first_min(cost: torch.Tensor):
    """(min, index of its first occurrence) of integer costs along the last
    dim (at most 32 wide, costs below 2^26), by one integer key."""
    n = cost.shape[-1]
    key = (cost * 32 + torch.arange(n, device=cost.device,
                                    dtype=cost.dtype)).amin(dim=-1)
    return key >> 5, key & 31


def bit_length4(v: torch.Tensor) -> torch.Tensor:
    """bit_length of v in [0, 15] via a comparison ladder."""
    return ((v > 0).to(torch.int32) + (v > 1) + (v > 3) + (v > 7))


def pick_sfc(t: EncoderTables, need1, need2, cost):
    """The cheapest scalefac_compress whose (slen1, slen2) hold `need1` and
    `need2` bits; the lowest code among equals. cost int32 [16]."""
    ok = (t.slen1[None] >= need1[:, None]) & (t.slen2[None] >= need2[:, None])
    _c, sfc = first_min(torch.where(ok, cost[None], _INVALID))
    return sfc


def split_spectrum(ix: torch.Tensor):
    """(a, b, bv, k) of quantized rows [R, 576] int32: the pairs' magnitudes,
    the big-values region in pairs and the count1 quads."""
    a = ix[:, 0::2].abs()
    b = ix[:, 1::2].abs()
    p1 = torch.arange(1, 289, device=ix.device, dtype=torch.int32)
    mx = torch.maximum(a, b)
    # one past the last nonzero pair, and one past the last pair above 1
    rzp = torch.where(mx > 0, p1, 0).amax(dim=1)
    rzp = rzp + (rzp & 1)
    bigp = torch.where(mx > 1, p1, 0).amax(dim=1)
    k = (rzp - bigp) // 2
    return a, b, rzp - 2 * k, k


def _count_rows(t: EncoderTables, ix: torch.Tensor, short_split: bool):
    """Exact big_values + count1 bit count for quantized rows [R, 576] int32.

    Returns (bits int32 [R], selr int32 [R, 3] table columns, bv, k, c1sel
    int32 [R]). All integer; mirrors vcount row for row."""
    R = ix.shape[0]
    dev = ix.device
    a, b, bv, k = split_spectrum(ix)
    bvl = bv.long()
    if short_split:
        r1 = torch.clamp(bv, max=t.fixed_pairs)
        r2 = bv
    else:
        r1 = t.r1p[bvl]
        r2 = t.r2p[bvl]
    edges = torch.stack([r1, r2, bv], dim=1).long()              # [R, 3]

    bins = (torch.clamp(a, max=16) * 17 + torch.clamp(b, max=16)).long()
    lens = t.m_len_t[:, bins]                                    # [T+1, R, 288]
    T1 = lens.shape[0]
    cs = torch.cumsum(lens, dim=2, dtype=torch.int16)
    at = torch.gather(cs, 2, (edges - 1).clamp(min=0)[None].expand(T1, -1, -1))
    at = at.permute(1, 2, 0).to(torch.int32)                     # [R, 3, T+1]
    at = torch.where((edges > 0)[:, :, None], at, 0)
    region = at - torch.cat([at.new_zeros(R, 1, T1), at[:, :2]], dim=1)
    bits_t = region[:, :, :-1]                                   # [R, 3, T]
    signs = region[:, :, -1]

    # validity from region maxima
    mxab = torch.maximum(a, b)
    pidx = torch.arange(288, device=dev, dtype=torch.int32)
    lo = torch.cat([edges.new_zeros(R, 1), edges[:, :2]], dim=1)
    inreg = ((pidx[None, None] >= lo[:, :, None])
             & (pidx[None, None] < edges[:, :, None]))           # [R, 3, 288]
    mxr = torch.where(inreg, mxab[:, None], 0).amax(dim=2)
    # integer bit length of the overflow: a comparison ladder, as one compare
    # against the 14 thresholds 2^k - 1
    ov = torch.clamp(mxr - 15, min=0)
    ladder = (1 << torch.arange(14, device=dev, dtype=torch.int32)) - 1
    blr = (ov[:, :, None] > ladder).sum(dim=2, dtype=torch.int32)
    valid = torch.where(t.is_esc[None, None], blr[:, :, None] <= t.linbits,
                        mxr[:, :, None] < t.xl)   # plain (and table 0: xl = 1)
    regmin, selr = first_min(torch.where(valid, bits_t, _INVALID))
    total = (regmin + signs).sum(dim=1)

    # count1: k quads on the quad grid after bv pairs
    nzq = (ix != 0).reshape(R, 144, 4).long()
    idxq = (nzq[..., 0] << 3) | (nzq[..., 1] << 2) | (nzq[..., 2] << 1) | nzq[..., 3]
    zero = ix.new_zeros(R, 1)
    csa = torch.cat([zero, torch.cumsum(t.c1a_sig[idxq], 1, dtype=torch.int32)], 1)
    csb = torch.cat([zero, torch.cumsum(t.c1b_sig[idxq], 1, dtype=torch.int32)], 1)
    q = torch.stack([bv // 2, bv // 2 + k], dim=1).long()
    ga = torch.gather(csa, 1, q)
    gb = torch.gather(csb, 1, q)
    ca = ga[:, 1] - ga[:, 0]
    cb = gb[:, 1] - gb[:, 0]
    total = total + torch.minimum(ca, cb)
    c1sel = (ca > cb).to(torch.int32)      # vcount's tie-break: A on equal
    return total, selr, bv, k, c1sel


def _quantize(p34, sign, gg):
    scale = torch.exp2(-0.75 * (gg[:, None].float() - 210.0) / 4.0)
    return sign * torch.floor(p34 * scale + MAGIC).to(torch.int32)


def _bisect_lo(p34, lo0):
    """The bisection's start per row: lo0 raised by the closed form of the
    scalar "+4 stepping" lower bound, the smallest lo0 + 4k with
    amax34 * 2^(-0.75 (lo - 210) / 4) <= IX_MAX
    <=> lo >= 210 + (4 / 0.75) * log2(amax34 / IX_MAX), at most 255."""
    amax34 = p34.amax(dim=1)
    need = 210.0 + (16.0 / 3.0) * (torch.log2(torch.clamp(amax34, min=1e-30))
                                   - float(np.log2(np.float32(IX_MAX))))
    ksteps = torch.clamp(torch.ceil((need - lo0.float()) / 4.0), min=0.0)
    return torch.where(amax34 > 0,
                       torch.clamp(lo0 + 4 * ksteps.to(torch.int32), max=255),
                       lo0)


def _inner_bisect(t, p34, sign, budgets, lo0, short_split: bool,
                  window: int | None = None):
    """Fixed-step bisection for the smallest fitting gg per row, over
    [lo, 255] (8 steps; window=None) or [lo, lo + window - 1] (5 steps).

    Returns (gg [R] i32, has_best [R] bool, capped [R] bool, next_lo [R]
    i32): capped = window exhausted below 255 with no fit (the caller
    advances gg_lo to next_lo and retries); next_lo = min(adjusted_lo +
    window, 255)."""
    R = p34.shape[0]
    lo = _bisect_lo(p34, lo0)
    if window is None:
        hi = torch.full_like(lo, 255)
        steps = _FULL_STEPS
    else:
        hi = torch.clamp(lo + (window - 1), max=255)
        steps = _WINDOW_STEPS
    hi0 = hi
    adj_lo = lo
    best = torch.full_like(lo, 210)
    has = torch.zeros(R, dtype=torch.bool, device=lo.device)
    for _ in range(steps):
        act = lo <= hi
        mid = (lo + hi) // 2
        ix = _quantize(p34, sign, mid)
        over = ix.abs().amax(dim=1) > IX_MAX
        bits = _count_rows(t, ix, short_split)[0]
        fits = act & ~over & (bits <= budgets)
        best = torch.where(fits, mid, best)
        has = has | fits
        hi = torch.where(fits, mid - 1, hi)
        lo = torch.where(act & ~fits, mid + 1, lo)
    capped = ~has & (hi0 < 255)
    next_lo = torch.clamp(adj_lo + (window or 0), max=255)
    return torch.where(has, best, 210), has, capped, next_lo


def _all_done(done: torch.Tensor) -> bool:
    """Every row of the block has converged (one sync), unless the loops run
    at fixed depth."""
    return not FIXED_DEPTH and bool(done.all())


def _sf_step(dist, xmin, room, jump: bool):
    """Scalefactor step per over-distorted band: half the band's log2
    noise/allowed gap (quantize.sf_jump_default; the same f32 formula as
    the host loops' sf_jump_steps), at most `room`, at least 1."""
    if not jump:
        return torch.ones_like(room)
    ratio = torch.clamp(dist / torch.clamp(xmin, min=1e-37), 1.0, 2.0 ** 60)
    k = torch.floor(0.5 * torch.log2(ratio)).to(torch.int32)
    return torch.minimum(torch.clamp(k, min=1), torch.clamp(room, min=1))


def _outer_long(t: EncoderTables, xr, xmin, budget_bits, max_iters: int,
                switched: bool, jump: bool) -> dict:
    """The outer loop over one block of long-layout rows. switched=True
    counts with the window-switched 2-region split (start/stop granules,
    block types 1/3: long spectrum and long sfb shaping, switched Huffman
    regions)."""
    dev = xr.device
    R = xr.shape[0]
    ax = xr.abs()
    p34_base = ax ** 0.75
    sign = torch.sign(xr).to(torch.int32)
    sf_cap = torch.tensor([15] * 11 + [7] * 10, dtype=torch.int32, device=dev)
    cost = 11 * t.slen1 + 10 * t.slen2
    i32 = lambda v: torch.full((R,), v, dtype=torch.int32, device=dev)
    false = lambda: torch.zeros(R, dtype=torch.bool, device=dev)

    def amp_of(sf):
        sf21 = torch.cat([sf, sf.new_zeros(R, 1)], dim=1)        # band 21 = 0
        return torch.exp2(sf21[:, t.band_of_line].float() / 2.0)

    sf = torch.zeros(R, 21, dtype=torch.int32, device=dev)
    gg_lo, done, best_gg, best_sf = i32(0), false(), i32(210), sf
    has_best, iters = false(), i32(0)
    it = 0
    # iteration 1: full-range gg bisection (8 steps); iterations >= 2 ride
    # the GG_WINDOW bisection (5 steps). Iterations after every row has
    # converged would change nothing (every update is masked by `done`, the
    # per-row iteration counter included), so the loop stops at all(done).
    while it < max_iters and not (it > 0 and _all_done(done)):
        window = None if it == 0 else GG_WINDOW
        it += 1
        iters = iters + (~done).to(torch.int32)     # per-row active iterations
        # scalefactor side-info cost
        need1 = bit_length4(sf[:, :11].amax(dim=1))
        need2 = bit_length4(sf[:, 11:21].amax(dim=1))
        sfc = pick_sfc(t, need1, need2, cost).long()
        budget = budget_bits - cost[sfc]
        done = done | (budget < 0)

        amp_line = amp_of(sf)
        p34 = p34_base * amp_line ** 0.75
        gg, has, capped, next_lo = rate_bisect.inner_bisect(
            t, p34, sign, budget, gg_lo, switched, window)
        upd = ~done & has
        best_gg = torch.where(upd, gg, best_gg)
        best_sf = torch.where(upd[:, None], sf, best_sf)
        has_best = has_best | upd
        gg_lo = torch.where(~done, torch.where(capped, next_lo, gg), gg_lo)

        # distortion per band at the found quantization
        ix = _quantize(p34, sign, gg)
        deq = (ix.abs().float() ** (4.0 / 3.0)) * \
            torch.exp2((gg[:, None].float() - 210.0) / 4.0) / amp_line
        dist = band_sums((ax - deq) ** 2, t.long_lines)
        over = (dist > xmin) & (sf < sf_cap) & ~done[:, None] & has[:, None]
        # a window-capped row is not converged: it retries the gg search
        # next iteration from next_lo, unamplified
        done = done | ~(over.any(dim=1) | capped)
        step = _sf_step(dist, xmin, sf_cap - sf, jump)
        sf = sf + torch.where(over, step, 0)

    if not bool(has_best.all()):
        # rows that never fit under shaping: plain rate loop, sf = 0
        gg_fb, has_fb, _c, _n = rate_bisect.inner_bisect(
            t, p34_base, sign, budget_bits, i32(0), switched)
        best_gg = torch.where(has_best, best_gg, gg_fb)
        best_sf = torch.where(has_best[:, None], best_sf, 0)
        has_any = has_best | has_fb
    else:
        has_any = has_best
    # final quantize + exact count at the chosen parameters (the emitted
    # spectrum IS this ix: the host never requantizes)
    ix = _quantize(p34_base * amp_of(best_sf) ** 0.75, sign, best_gg)
    ix = torch.where(has_any[:, None], ix, 0)
    bits, selr, _bv, _k, c1sel = rate_bisect.count_rows(t, ix, switched)
    return dict(gg=best_gg, sf=best_sf, has=has_any, ix=ix.to(torch.int16),
                bits=bits, selr=selr, c1=c1sel, conv=done, iters=iters)


def _outer_short(t: EncoderTables, xr, xmin, budget_bits, max_iters: int,
                 jump: bool) -> dict:
    """The outer loop over one block of short-block rows: per-window
    scalefactors [R, 3, 12] and subblock_gain [R, 3]."""
    dev = xr.device
    R = xr.shape[0]
    ax = xr.abs()
    p34_base = ax ** 0.75
    sign = torch.sign(xr).to(torch.int32)
    sf_cap = torch.tensor([15] * 6 + [7] * 6, dtype=torch.int32, device=dev)
    cost = 18 * (t.slen1 + t.slen2)
    i32 = lambda v: torch.full((R,), v, dtype=torch.int32, device=dev)
    false = lambda: torch.zeros(R, dtype=torch.bool, device=dev)

    def amp_of(sf, sbg):
        sf13 = torch.cat([sf, sf.new_zeros(R, 3, 1)], dim=2)
        q = 8 * sbg[:, :, None] + 2 * sf13                       # [R, 3, 13]
        return torch.exp2(q[:, t.wline, t.sline].float() / 4.0)

    sf = torch.zeros(R, 3, 12, dtype=torch.int32, device=dev)
    sbg = torch.zeros(R, 3, dtype=torch.int32, device=dev)
    gg_lo, done, best_gg = i32(0), false(), i32(210)
    best_sf, best_sbg = sf, sbg
    has_best, iters = false(), i32(0)
    it = 0
    # iteration 1 full-range, then GG_WINDOW bisection, until all(done): see
    # _outer_long
    while it < max_iters and not (it > 0 and _all_done(done)):
        window = None if it == 0 else GG_WINDOW
        it += 1
        iters = iters + (~done).to(torch.int32)
        need1 = bit_length4(sf[:, :, :6].amax(dim=(1, 2)))
        need2 = bit_length4(sf[:, :, 6:12].amax(dim=(1, 2)))
        sfc = pick_sfc(t, need1, need2, cost).long()
        budget = budget_bits - cost[sfc]
        done = done | (budget < 0)

        amp = amp_of(sf, sbg)
        p34 = p34_base * amp ** 0.75
        gg, has, capped, next_lo = rate_bisect.inner_bisect(
            t, p34, sign, budget, gg_lo, True, window)
        upd = ~done & has
        best_gg = torch.where(upd, gg, best_gg)
        best_sf = torch.where(upd[:, None, None], sf, best_sf)
        best_sbg = torch.where(upd[:, None], sbg, best_sbg)
        has_best = has_best | upd
        gg_lo = torch.where(~done, torch.where(capped, next_lo, gg), gg_lo)

        ix = _quantize(p34, sign, gg)
        deq = (ix.abs().float() ** (4.0 / 3.0)) * \
            torch.exp2((gg[:, None].float() - 210.0) / 4.0) / amp
        dist = band_sums((ax - deq) ** 2, t.short_lines).reshape(
            R, 3, 13)[:, :, :12]
        over = (dist > xmin) & ((sf < sf_cap) | (sbg[:, :, None] < 7)) & \
            ~done[:, None, None] & has[:, None, None]
        # window-capped rows are not converged (see the long loop)
        done = done | ~(over.reshape(R, -1).any(dim=1) | capped)
        # at most one step past the slen cap per iteration: the overshoot
        # escalates subblock_gain (see quantize)
        step = _sf_step(dist, xmin, sf_cap + 1 - sf, jump)
        sf = sf + torch.where(over, step, 0)
        exceed = (sf > sf_cap).any(dim=2)                        # [R, 3]
        bump = exceed & (sbg < 7)
        sbg = sbg + bump.to(torch.int32)
        sf = torch.where(bump[:, :, None], torch.clamp(sf - 4, min=0), sf)
        sf = torch.where(exceed[:, :, None], torch.minimum(sf, sf_cap), sf)

    if not bool(has_best.all()):
        gg_fb, has_fb, _c, _n = rate_bisect.inner_bisect(
            t, p34_base, sign, budget_bits, i32(0), True)
        best_gg = torch.where(has_best, best_gg, gg_fb)
        best_sf = torch.where(has_best[:, None, None], best_sf, 0)
        best_sbg = torch.where(has_best[:, None], best_sbg, 0)
        has_any = has_best | has_fb
    else:
        has_any = has_best
    ix = _quantize(p34_base * amp_of(best_sf, best_sbg) ** 0.75, sign, best_gg)
    ix = torch.where(has_any[:, None], ix, 0)
    bits, selr, _bv, _k, c1sel = rate_bisect.count_rows(t, ix, True)
    return dict(gg=best_gg, sf=best_sf, sbg=best_sbg, has=has_any,
                ix=ix.to(torch.int16), bits=bits, selr=selr, c1=c1sel,
                conv=done, iters=iters)


def _rate_only(t: EncoderTables, xr, budgets, short_split: bool) -> dict:
    """Rate-only bisection over one block (no shaping)."""
    p34 = xr.abs() ** 0.75
    sign = torch.sign(xr).to(torch.int32)
    gg, has, _c, _n = rate_bisect.inner_bisect(
        t, p34, sign, budgets, torch.zeros_like(budgets), short_split)
    ix = _quantize(p34, sign, gg)
    ix = torch.where(has[:, None], ix, 0)
    bits, selr, _bv, _k, c1sel = rate_bisect.count_rows(t, ix, short_split)
    return dict(gg=gg, has=has, ix=ix.to(torch.int16), bits=bits, selr=selr,
                c1=c1sel)


def _coded_mask(nbits, width: int):
    """[R, width] bool (of nbits' kind, tensor or array): the bytes of each
    row that hold its nbits coded bits."""
    nby = (nbits + 7) >> 3
    if isinstance(nbits, torch.Tensor):
        return torch.arange(width, device=nbits.device)[None] < nby[:, None]
    return np.arange(width)[None] < nby[:, None]


def to_host(tensors) -> list:
    """numpy copies of device tensors, all started before the first wait."""
    return [c.numpy() for c in [HostCopy(x) for x in tensors]]


class _Pending:
    """One group's loop results, kept as device tensors [n, ...] so that the
    caller can decide LATER which outputs and rows to bring to the host.
    Used by encode_batch's two-pass reservoir walk: pass A only needs the
    per-row bit counts and scalefactors to plan upgrades, the rows that
    pass B re-quantizes are never emitted, and the kept rows come down as
    packed bytes (emit_and_take).

    Keys: gg, has, ix (int16), bits, selr (TABLE_IDS columns), c1; the outer
    loops add sf, conv, iters, and the short one sbg."""

    def __init__(self, out: dict, sample_rate: int):
        self.out = out
        self.sample_rate = sample_rate

    def take(self, *names):
        """Download only the named outputs, whole."""
        return tuple(to_host([self.out[k] for k in names]))

    def fetch_rows(self, rows=None) -> dict:
        """Every output, for the given local row positions (all when None),
        as numpy."""
        keys = list(self.out)
        if rows is None:
            vals = [self.out[k] for k in keys]
        else:
            sel = torch.as_tensor(np.asarray(rows, np.int64),
                                  device=self.out["gg"].device)
            vals = [self.out[k].index_select(0, sel) for k in keys]
        return dict(zip(keys, to_host(vals)))

    def emit_and_take(self, layout: str, use_sf: bool, rows):
        """Emit the given local rows on the device (encoder/emit_device.py)
        and download the packed part2+part3 BYTES plus the side-info smalls;
        the spectra stay on the device.

        Returns host arrays aligned with `rows`: (bytes [n, 520], meta
        [n, 5] (p23, bv, sfc, r0c, r1c), gg, tsel columns, c1, huffman bits,
        sbg-or-None)."""
        from . import emit_device
        o = self.out
        dev = o["gg"].device
        sel = torch.as_tensor(np.asarray(rows, np.int64), device=dev)
        pick = lambda k: o[k].index_select(0, sel)
        selr, c1 = pick("selr"), pick("c1")
        ix = pick("ix")
        sf = pick("sf") if (use_sf and "sf" in o) else None
        by, meta = [], []
        step = row_block(dev)
        for lo in range(0, len(sel), step):
            s = slice(lo, lo + step)
            words, m = emit_device.emit_rows_device(
                ix[s], None if sf is None else sf[s], selr[s], c1[s],
                self.sample_rate, layout, use_sf and sf is not None)
            # only each row's coded bytes come to the host, end to end
            rows_b = emit_device.words_to_bytes(words)
            by.append(rows_b[_coded_mask(m[:, 0], rows_b.shape[1])])
            meta.append(m)
        cat = lambda parts: parts[0] if len(parts) == 1 else torch.cat(parts)
        outs = [cat(by), cat(meta), pick("gg"), selr, c1, pick("bits")]
        if "sbg" in o:
            outs.append(pick("sbg"))
        host = to_host(outs)
        width = emit_device.CAP_WORDS * 4
        rows_h = np.zeros((len(sel), width), np.uint8)
        rows_h[_coded_mask(host[1][:, 0], width)] = host[0]
        host[0] = rows_h
        return tuple(host) if "sbg" in o else tuple(host) + (None,)


def _run_gathered(fn, sample_rate, xr_dev, xmin_dev, idx, budgets) -> _Pending:
    """Run the loop `fn` over blocks of rows gathered from DEVICE-resident
    tensors (no host round-trip of the spectra): idx and budgets are small
    host arrays; xr_dev [N, 576] f32 and the optional xmin_dev [N, ...] f32
    live on the device (SURVEY.md §3.4: one host/device boundary per batch).
    The results stay on the device, in a _Pending."""
    dev = xr_dev.device
    t = encoder_tables(sample_rate, dev)
    sel_all = torch.as_tensor(np.asarray(idx, np.int64), device=dev)
    bud_all = torch.as_tensor(np.asarray(budgets, np.int32), device=dev)
    step = row_block(dev)
    blocks = []
    for lo in range(0, max(len(sel_all), 1), step):
        sel = sel_all[lo: lo + step]
        args = [xr_dev.index_select(0, sel)]
        if xmin_dev is not None:
            args.append(xmin_dev.index_select(0, sel))
        blocks.append(fn(t, *args, bud_all[lo: lo + step]))
    out = {k: (blocks[0][k] if len(blocks) == 1
               else torch.cat([b[k] for b in blocks])) for k in blocks[0]}
    return _Pending(out, sample_rate)


ITER_STATS: dict = {}   # kind -> np.int64[max_iters + 1] bincount of the
#                         per-row outer-loop iteration counts (rate-loop
#                         telemetry); filled when MP3TPU_ITER_HIST=1


def take_iter_stats(pend: _Pending, label: str):
    """Fold a pending group's per-row outer-iteration counters into
    ITER_STATS under `label` (a no-op unless MP3TPU_ITER_HIST=1; rate-only
    groups have no counters). encode_batch calls it for every group it
    emits rows of."""
    if not os.environ.get("MP3TPU_ITER_HIST") or "iters" not in pend.out:
        return
    h = np.bincount(np.asarray(pend.take("iters")[0], np.int64))
    cur = ITER_STATS.get(label, np.zeros(0, np.int64))
    new = np.zeros(max(len(h), len(cur)), np.int64)
    new[: len(cur)] += cur
    new[: len(h)] += h
    ITER_STATS[label] = new


# The loops' entry points: each runs its loop over rows gathered on the
# device and returns the _Pending with nothing downloaded; the caller takes
# what it needs when it needs it (_Pending.take, fetch_rows, emit_and_take).

def outer_rows_gathered_pending(xr_dev, xmin_dev, idx, budgets, sample_rate,
                                max_iters=16, block_type=0) -> _Pending:
    """block_type 1/3 selects the window-switched region split for the bit
    counter (start/stop shaping)."""
    jump = sf_jump_default()
    fn = lambda t, xr, xmin, bud: _outer_long(
        t, xr, xmin, bud, max_iters, bool(block_type), jump)
    return _run_gathered(fn, sample_rate, xr_dev, xmin_dev, idx, budgets)


def outer_rows_short_gathered_pending(xr_dev, xmin_dev, idx, budgets,
                                      sample_rate, max_iters=12) -> _Pending:
    jump = sf_jump_default()
    fn = lambda t, xr, xmin, bud: _outer_short(t, xr, xmin, bud, max_iters, jump)
    return _run_gathered(fn, sample_rate, xr_dev, xmin_dev, idx, budgets)


def rate_rows_gathered_pending(xr_dev, idx, budgets, sample_rate,
                               block_type) -> _Pending:
    fn = lambda t, xr, bud: _rate_only(t, xr, bud, bool(block_type))
    return _run_gathered(fn, sample_rate, xr_dev, None, idx, budgets)
