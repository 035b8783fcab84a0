"""Device Huffman EMISSION (SURVEY.md E5 on the device).

Counterpart of mp3tpu.encoder.emit_device. Produces the packed part2+part3
bitstream of granule-channel rows ON THE DEVICE, so that the host downloads
the coded bytes (an entropy-sized payload) instead of the spectra: the one
emitter of encode_batch.

Formulation:
  - the big-values/count1/rzero split, region ids and table columns reuse
    the exact vloop_device formulas (count == emit is the reservoir
    contract; this emitter must land on the counted bit budget row for
    row);
  - per-symbol (value, length) fields are table gathers and elementwise
    integer math: 36 scalefactor slots, 288 pairs x 5 fields (code,
    linbits-x, sign-x, linbits-y, sign-y), 144 quads x 5 fields (code, 4
    signs) -> [R, 2196] field vectors in exact emission order;
  - MSB-first bit packing places each field's contribution to the word it
    starts in and to the next one with an integer scatter_add: the fields'
    bits are disjoint, so add is or, and integer adds give the same words
    in any order. Words are int64 masked to 32 bits.

Byte-identical to huffcode.encode_granule, the reference (tested row for
row).
"""
from __future__ import annotations

import numpy as np
import torch

from .tables import EncoderTables, encoder_tables
from .vloop_device import bit_length4, pick_sfc, split_spectrum

SPF = 576
FIELDS = 36 + 288 * 5 + 144 * 5          # sf + pairs + quads
# 4095-bit part2_3 max = 128 words + 1 spill; 130 words = 520-byte rows, the
# row width of the packed mux's input
CAP_WORDS = 130


def _pack_words(V: torch.Tensor, L: torch.Tensor, W: int) -> torch.Tensor:
    """MSB-first pack: fields (V, L) int64 [R, F] -> words int64 [R, W],
    each below 2^32. A field that starts beyond word W - 1 is dropped."""
    off = torch.cumsum(L, dim=1) - L
    w = torch.clamp(off >> 5, max=W)
    sh = 32 - (off & 31) - L
    # both branches are evaluated: clamp the shift amounts into [0, 31]
    hi = torch.where(sh >= 0, V << sh.clamp(0, 31), V >> (-sh).clamp(0, 31))
    lo = torch.where(sh >= 0, torch.zeros_like(V),
                     (V << (32 + sh).clamp(0, 31)) & 0xFFFFFFFF)
    live = L > 0
    hi = torch.where(live, hi, torch.zeros_like(hi))
    lo = torch.where(live, lo, torch.zeros_like(lo))
    words = V.new_zeros(V.shape[0], W + 2)                # two spill columns
    words.scatter_add_(1, w, hi)
    words.scatter_add_(1, w + 1, lo)
    return words[:, :W]


def _emit(t: EncoderTables, ix, sf, selr, c1sel, layout: str, use_sf: bool,
          W: int):
    """layout: "long" (block type 0), "switched" (1/3: long spectrum, fixed
    2-region split, long sf), "short" (2: fixed split, short sf). Returns
    (words int64 [R, W], meta int32 [R, 5])."""
    switched = layout != "long"
    short = layout == "short"
    ix = ix.to(torch.int32)
    R = ix.shape[0]
    dev = ix.device
    a, b, bv, k = split_spectrum(ix)
    bvl = bv.long()
    if switched:
        r1 = torch.clamp(bv, max=t.fixed_pairs)
        r2 = bv
        r0c = torch.full_like(bv, 8 if short else 7)
        r1c = 20 - r0c
    else:
        r1, r2 = t.emit_r1p[bvl], t.emit_r2p[bvl]
        r0c, r1c = t.r0c_t[bvl], t.r1c_t[bvl]

    pidx = torch.arange(288, device=dev, dtype=torch.int32)
    rid = ((pidx[None] >= r1[:, None]).long() + (pidx[None] >= r2[:, None]))
    active = pidx[None] < bv[:, None]
    tcol = torch.gather(selr.long(), 1, rid)                     # [R, 288]
    cx = torch.clamp(a, max=15).long()
    cy = torch.clamp(b, max=15).long()
    entry = t.lut[tcol * 256 + cx * 16 + cy].long()
    esc = t.esc16[tcol]
    lb = t.emit_linbits[tcol].long()
    zero = torch.zeros_like(entry)
    act = active.long()
    a64, b64 = a.long(), b.long()
    Vp = torch.stack([entry & ((1 << 19) - 1), torch.clamp(a64 - 15, min=0),
                      (ix[:, 0::2] < 0).long(), torch.clamp(b64 - 15, min=0),
                      (ix[:, 1::2] < 0).long()], dim=2)
    Lp = torch.stack([(entry >> 19) * act,
                      torch.where(active & esc & (a >= 15), lb, zero),
                      (active & (a > 0)).long(),
                      torch.where(active & esc & (b >= 15), lb, zero),
                      (active & (b > 0)).long()], dim=2)

    # count1 quads: k on the quad grid after bv pairs
    q = ix.reshape(R, 144, 4).long()
    aq = q.abs()
    qi = torch.arange(144, device=dev, dtype=torch.int32)
    q0 = bv // 2
    qact = (qi[None] >= q0[:, None]) & (qi[None] < (q0 + k)[:, None])
    idxq = (aq[..., 0] << 3) | (aq[..., 1] << 2) | (aq[..., 2] << 1) | aq[..., 3]
    idxq = torch.clamp(idxq, max=15)         # inactive quads may exceed
    ea = t.c1a[idxq].long()
    use_b = (c1sel != 0)[:, None]
    qcode = torch.where(use_b, 15 - idxq, ea & ((1 << 19) - 1))
    qlen = torch.where(use_b, torch.full_like(ea, 4), ea >> 19)
    Vq = torch.cat([qcode[:, :, None], (q < 0).long()], dim=2)
    Lq = torch.cat([(qlen * qact.long())[:, :, None],
                    (qact[:, :, None] & (aq > 0)).long()], dim=2)

    # scalefactors (part2): 36 slots, layout-dependent lengths
    Vs = torch.zeros(R, 36, dtype=torch.int64, device=dev)
    Ls = torch.zeros(R, 36, dtype=torch.int64, device=dev)
    sfc = torch.zeros(R, dtype=torch.int32, device=dev)
    if use_sf:
        sfi = sf.to(torch.int32)
        if short:
            # sf [R, 3, 12] window-major -> emission is sfb-major,
            # window-minor; slen1 covers sfb 0-5, slen2 sfb 6-11
            need1 = bit_length4(sfi[:, :, :6].amax(dim=(1, 2)))
            need2 = bit_length4(sfi[:, :, 6:12].amax(dim=(1, 2)))
            sfc = pick_sfc(t, need1, need2, 18 * (t.slen1 + t.slen2))
            vs = sfi.transpose(1, 2).reshape(R, 36)
            n1, n2, dead = 18, 18, 0
        else:
            # long: 11 bands at slen1, 10 at slen2, 15 dead slots
            need1 = bit_length4(sfi[:, :11].amax(dim=1))
            need2 = bit_length4(sfi[:, 11:21].amax(dim=1))
            sfc = pick_sfc(t, need1, need2, 11 * t.slen1 + 10 * t.slen2)
            vs = torch.cat([sfi[:, :21], sfi.new_zeros(R, 15)], dim=1)
            n1, n2, dead = 11, 10, 15
        s1 = t.slen1[sfc.long()][:, None]
        s2 = t.slen2[sfc.long()][:, None]
        ls = torch.cat([s1.expand(R, n1), s2.expand(R, n2),
                        s1.new_zeros(R, dead)], dim=1)
        emit_any = (vs != 0).any(dim=1)
        Vs = (vs * emit_any[:, None]).long()
        Ls = (ls * emit_any[:, None]).long()
        sfc = sfc * emit_any

    V = torch.cat([Vs, Vp.reshape(R, -1), Vq.reshape(R, -1)], dim=1)
    L = torch.cat([Ls, Lp.reshape(R, -1), Lq.reshape(R, -1)], dim=1)
    nbits = L.sum(dim=1)
    words = _pack_words(V, L, W)
    meta = torch.stack([nbits.to(torch.int32), bv, sfc.to(torch.int32), r0c,
                        r1c], dim=1)
    return words, meta


def emit_rows_device(ix, sf, tsel_cols, c1sel, sample_rate: int, layout: str,
                     use_sf: bool, W: int = CAP_WORDS, device=None):
    """Emit rows on the device from device tensors (or host arrays, which go
    to `device` first); returns device tensors (words int64 [R, W], the
    MSB-first big-endian 32-bit word stream, and meta int32 [R, 5] =
    (part2_3_length, big_values, scalefac_compress, region0_count,
    region1_count)). tsel_cols are TABLE_IDS COLUMN indices (the loops' selr
    output), not raw table ids. sf may be None when use_sf is off."""
    if device is None:
        device = ix.device if isinstance(ix, torch.Tensor) else "cuda"
    dev = lambda x: (x if isinstance(x, torch.Tensor)
                     else torch.as_tensor(np.asarray(x))).to(device)
    t = encoder_tables(sample_rate, device)
    return _emit(t, dev(ix), dev(sf) if use_sf else None, dev(tsel_cols),
                 dev(c1sel), layout, bool(use_sf), W)


def words_to_bytes(words):
    """MSB-first 32-bit words [R, W] (a tensor or an array) -> the emitter's
    byte rows [R, W * 4] uint8, of the same kind."""
    if isinstance(words, torch.Tensor):
        parts = [(words >> s) & 0xFF for s in (24, 16, 8, 0)]
        return torch.stack(parts, dim=2).to(torch.uint8).reshape(
            words.shape[0], -1)
    return np.ascontiguousarray(words).astype(">u4").view(np.uint8).reshape(
        words.shape[0], -1)
