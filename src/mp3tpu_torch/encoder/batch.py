"""Batched multi-stream encoder (SURVEY.md §3.4).

Counterpart of mp3tpu.encoder.batch. encode_batch() is the encoder's
aggregate-throughput path: many streams encode together, and the spectra
stay DEVICE-RESIDENT from the analysis transform through the rate loops;
the host sees only small control tensors plus the coded bytes:

  stage PCM            once, from pinned memory (int16 where the samples
                       are int16-origin)
  E1+E2 transform      device -> spectra [B*nch, G, 576]
  E3 psymodel 2        device, on the SAME staged pcm
  MS decision + xmin   device (energies down, masks up: KBs)
  E4 rate/distortion   device loops per block-type group, rows GATHERED
                       on the device (vloop_device.*_gathered); the
                       device's final f32 quantize IS the emitted
                       spectrum and its integer bit count / table
                       selection is exact for it (count == emit)
  reservoir control    host per stream (two-pass deterministic walk,
                       same policy as encode_pcm: SURVEY.md §7.5-5
                       keeps loop CONTROL on host)
  E5/E6 emission       device emitter (emit_device) or the C++ row
                       emitter (bit for bit the Python encode_granule),
                       then the packed mux (mux_packed)

The single-stream encode_pcm (numpy lockstep, f64 scalar-exact) is the
reference; encode_batch's device search differs from it only by half-step
rounding at f32 quantization boundaries (still a valid quantizer) while
honoring the same budget/reservoir contracts: every granule's EXACT coded
size is known before mux, and a per-frame overdraft guard refits against
the true reservoir. Streams must share sample_rate/channel count; mixed
batches fall back to encode_pcm.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..container.frames import BITRATES_V1_L3
from ..utils.profiling import annotate
from . import vloop, vloop_device
from .huffcode import encode_granule
from .mux import FrameSizer, ReservoirMux, build_xing_frame, \
    frame_capacity_bits
from .psymodel import MDCT_ALIGN, align_to_mdct, block_type_sequence
from . import ENCODER_DELAY, SPF, SR_IDX
from .tables import band_sums, encoder_tables

S2 = 1.0 / np.sqrt(2.0)

# last MP3TPU_ENCODE_PROFILE=1 phase walls
LAST_PROFILE: dict = {}


class _Phases:
    """The phases of one encode_batch: each a named range
    (utils.profiling.annotate) and, under MP3TPU_ENCODE_PROFILE=1, a wall
    that ends with the device's queue drained, so that it holds the phase's
    device work."""

    def __init__(self, device):
        self.prof = os.environ.get("MP3TPU_ENCODE_PROFILE") == "1"
        self.device = device
        self.walls: dict = {}
        self._span = None
        self._t0 = time.perf_counter()

    def start(self, name):
        self.close()
        self._name = name
        self._span = annotate("mp3tpu.encode." + name)
        self._span.__enter__()

    def close(self):
        if self._span is None:
            return
        self._span.__exit__(None, None, None)
        self._span = None
        if self.prof:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t = time.perf_counter()
            self.walls[self._name] = (self.walls.get(self._name, 0.0)
                                      + t - self._t0)
            self._t0 = t


def _energies(X: torch.Tensor, nch: int):
    """X [B*nch, G, 576] -> per-granule channel energies [B, nch, G] and
    (for stereo) mid/side energies [B, G] for the frame MS decision."""
    Bn, G, _ = X.shape
    X2 = X.reshape(Bn // nch, nch, G, 576)
    e_gc = (X2 * X2).sum(dim=3)
    if nch == 2:
        mid = (X2[:, 0] + X2[:, 1]) * S2
        side = (X2[:, 0] - X2[:, 1]) * S2
        e_m = (mid * mid).sum(dim=2)
        e_s = (side * side).sum(dim=2)
    else:
        e_m = e_s = X.new_zeros(Bn // nch, G)
    return e_m, e_s, e_gc


def _prep(t, X, nch: int, msg, ratio_l, ratio_s, short_row):
    """Apply mid/side on flagged granules and build the loop inputs, all on
    the device.

    X [B*nch, G, 576]; msg [B, G] bool; ratio_l [B*nch, G, 21]; ratio_s
    [B*nch, G, 3, 12]; short_row [B*G*nch] bool. Returns rows [B*G*nch,
    576], xmin_l [., 21], xmin_s [., 3, 12] (row id = (b*G + g)*nch + c)."""
    Bn, G, _ = X.shape
    B = Bn // nch
    X2 = X.reshape(B, nch, G, 576)
    rl = ratio_l.reshape(B, nch, G, 21)
    rs = ratio_s.reshape(B, nch, G, 3, 12)
    if nch == 2:
        mid = (X2[:, 0] + X2[:, 1]) * S2
        side = (X2[:, 0] - X2[:, 1]) * S2
        m = msg[:, None, :, None]
        X2 = torch.where(m, torch.stack([mid, side], 1), X2)
        both_l = torch.minimum(rl[:, 0], rl[:, 1])[:, None]
        both_s = torch.minimum(rs[:, 0], rs[:, 1])[:, None]
        rl = torch.where(m, both_l, rl)
        rs = torch.where(msg[:, None, :, None, None], both_s, rs)
    rows = X2.permute(0, 2, 1, 3).reshape(-1, 576)
    rl_rows = rl.permute(0, 2, 1, 3).reshape(-1, 21)
    rs_rows = rs.permute(0, 2, 1, 3, 4).reshape(-1, 3, 12)
    rs_rows = torch.where(short_row[:, None, None], rs_rows, 1e9)
    p2 = rows * rows
    en_l = band_sums(p2, t.long_lines)
    en_s = band_sums(p2, t.short_lines).reshape(-1, 3, 13)[:, :, :12]
    return rows, rl_rows * en_l, rs_rows * en_s


def encode_batch(pcms, sample_rate: int | None = None,
                 bitrate: int | None = None,
                 gapless_tag: bool | None = None,
                 short_blocks: bool | None = None,
                 joint_stereo: bool | None = None,
                 noise_shaping: bool | None = None,
                 reservoir: bool = True, device="cuda") -> list[bytes]:
    """Encode a batch of float PCM arrays ([n] or [n, ch], same channel
    count and sample rate) to MP3 bytes. See module docstring.

    pcms may also be a DecodedBatch handle (decode_batch(...,
    output="device")): the device-resident transcode path. The int16
    PCM is trimmed/dequantized/padded in device memory (one gather per
    decode chunk) and block-type labels come from a device sub-block
    energy reduction: no staging H2D and no decode D2H. sample_rate
    is inferred from the handle (must be uniform), and the encode runs
    where the handle's PCM lies. Output is bit-identical to encoding the
    handle's .numpy() PCM, except that transient labels derive from f32
    device energies instead of f64 host energies (same decision logic,
    ULP-level input difference). Host-fallback records and mixed channel
    counts materialize to the host path (correct, not zero-copy).

    Unset parameters fall back to the active EncodeConfig (SURVEY.md
    §5.6), mirroring encode_pcm. device ("cuda" by default) is where the
    device stages run; on a card the C++ emitter and mux are required
    (no Python fallback), as the C++ unpacker is for the decode."""
    from ..config import get_active
    ecfg = get_active().encode
    bitrate = ecfg.bitrate if bitrate is None else bitrate
    gapless_tag = ecfg.gapless_tag if gapless_tag is None else gapless_tag
    short_blocks = ecfg.short_blocks if short_blocks is None else short_blocks
    joint_stereo = ecfg.joint_stereo if joint_stereo is None else joint_stereo
    noise_shaping = (ecfg.noise_shaping if noise_shaping is None
                     else noise_shaping)
    if bitrate not in BITRATES_V1_L3:
        raise ValueError("unsupported bitrate")
    is_dev_batch = (hasattr(pcms, "device_pcm")
                    and hasattr(pcms, "sample_rates"))
    if not is_dev_batch and sample_rate not in SR_IDX:
        raise ValueError("unsupported sample rate")
    # ---- device-resident input (DecodedBatch, SURVEY.md §3.2) -----------
    # transcode path: decode_batch(output="device") -> encode_batch: the
    # PCM stays on the device (no stage H2D, no decode D2H). Host-fallback
    # records and mixed channels materialize to the host path below
    # (correct, just not zero-copy).
    recs = None
    if is_dev_batch:
        rates = set(pcms.sample_rates)
        if len(rates) != 1:
            raise ValueError("device-batch encode needs one sample rate, "
                             f"got {sorted(rates)}")
        rate = rates.pop()
        if sample_rate is not None and sample_rate != rate:
            raise ValueError(f"sample_rate {sample_rate} != decoded {rate}")
        sample_rate = rate
        if sample_rate not in SR_IDX:
            raise ValueError("unsupported decoded sample rate")
        recs = [pcms.device_pcm(i) for i in range(len(pcms))]
        nchs = {r[4] for r in recs}
        on = [r[0].device for r in recs if isinstance(r[0], torch.Tensor)]
        if on:      # the encode runs where the handle's PCM lies
            device = on[0]
        if (len(nchs) != 1 or next(iter(nchs)) > 2 or len(on) < len(recs)):
            pcms = [p.astype(np.float64) / 32768.0 for p, _sr in pcms.numpy()]
            recs = None
    device = torch.device(device)

    arrs = []
    if recs is None:
        for p in pcms:
            a = np.asarray(p, np.float64)
            if a.ndim == 1:
                a = a[:, None]
            arrs.append(a)
        nchs = {a.shape[1] for a in arrs}
        if len(nchs) != 1 or arrs[0].shape[1] > 2:
            from . import encode_pcm
            return [encode_pcm(a, sample_rate, bitrate=bitrate,
                               gapless_tag=gapless_tag,
                               short_blocks=short_blocks,
                               joint_stereo=joint_stereo,
                               noise_shaping=noise_shaping,
                               reservoir=reservoir, device=device)
                    for a in arrs]
    phases = _Phases(device)
    try:
        return _encode_batch(arrs, recs, sample_rate, bitrate, gapless_tag,
                             short_blocks, joint_stereo, noise_shaping,
                             reservoir, device, bool(ecfg.device_emit), phases)
    finally:
        phases.close()


def _encode_batch(arrs, recs, sample_rate, bitrate, gapless_tag, short_blocks,
                  joint_stereo, noise_shaping, reservoir, device, cfg_emit,
                  phases) -> list[bytes]:
    """encode_batch on resolved arguments: float64 arrays [n, nch] (recs
    None), or the DecodedBatch's device records."""
    from .device import (gather_rows, granule_spectra_device_handle,
                         stage_pcm, subblock_energy)
    on_card = device.type == "cuda"
    _prof = phases.prof
    _ph = phases.walls
    phases.start("host_prep")
    if recs is None:
        nch = arrs[0].shape[1]
        B = len(arrs)
    else:
        nch = recs[0][4]
        B = len(recs)
    sr_idx = SR_IDX[sample_rate]
    br_idx = BITRATES_V1_L3.index(bitrate)

    # ---- per-stream padding / block types -------------------------------
    G_s, pad_s, bts_s, encpad_s = [], [], [], []
    ns = ([len(a) for a in arrs] if recs is None
          else [int(r[3] - r[2]) for r in recs])
    for s, n in enumerate(ns):
        total_needed = n + ENCODER_DELAY + 529
        G = -(-total_needed // SPF)
        G += G & 1
        G_s.append(G)
        encpad_s.append(G * SPF - ENCODER_DELAY - n)
        if recs is not None:
            continue  # PCM stays on device; labels after the gather
        padded = np.zeros((G * SPF, nch))
        padded[:n] = arrs[s]
        pad_s.append(padded)
    Gmax = max(G_s)

    # ---- stage once; transform + psymodel on device ---------------------
    phases.start("stage")
    T = Gmax * SPF
    if recs is not None:
        # one gather per run of streams sharing a decode chunk: trim +
        # dequantize + zero-pad in device memory (device.gather_rows)
        blocks = []
        i = 0
        while i < B:
            chunk = recs[i][0]
            k = i
            while k < B and recs[k][0] is chunk:
                k += 1
            blocks.append(gather_rows(
                chunk, [recs[j][1] for j in range(i, k)],
                [recs[j][2] for j in range(i, k)], ns[i:k], T, nch))
            i = k
        pcm_bnt = blocks[0] if len(blocks) == 1 else torch.cat(blocks)
        if short_blocks:
            # reduction on device, decision on host: same semantics as
            # the host path (shared block_types_from_subblock_energy);
            # energies are f32 here vs f64 there (ULP-level, tested)
            from .psymodel import block_types_from_subblock_energy
            e = subblock_energy(pcm_bnt, MDCT_ALIGN).cpu().numpy().astype(
                np.float64)                                 # [B, T // 64]
            bts_s = [block_types_from_subblock_energy(e[s, : G_s[s] * 9])
                     for s in range(B)]
        else:
            bts_s = [np.zeros(G, np.int64) for G in G_s]
        pcm_dev = pcm_bnt.reshape(B * nch, T)
        staged_i16 = True
    else:
        pcm_b = np.zeros((B * nch, T), np.float32)
        for s in range(B):
            for c in range(nch):
                pcm_b[s * nch + c, : G_s[s] * SPF] = pad_s[s][:, c]
        pcm_dev, staged_i16 = stage_pcm(pcm_b, device)
        # block-type labels on the MDCT-aligned copy (psymodel.MDCT_ALIGN:
        # granule g's spectrum holds time content delayed by the analysis
        # chain, so unshifted labels switch one granule early), computed
        # after the staging copy is queued, so that this host work runs
        # beside it
        bts_s = [block_type_sequence(align_to_mdct(pad_s[s]), sample_rate)
                 if short_blocks else np.zeros(G_s[s], np.int64)
                 for s in range(B)]
    bts_b = np.zeros((B * nch, Gmax), np.int64)
    for s in range(B):
        for c in range(nch):
            bts_b[s * nch + c, : G_s[s]] = bts_s[s]
    if _prof:
        _ph['stage_int16'] = int(staged_i16)
    phases.start("transform_psy")
    tables = encoder_tables(sample_rate, device)
    X = granule_spectra_device_handle(pcm_dev, bts_b, sample_rate)
    if noise_shaping:
        from .psy_device import analyze_batch_handle
        # align: the staged pcm is unshifted (the MDCT shares it); the
        # psymodel's analysis frames start MDCT_ALIGN earlier instead
        rl_dev, rs_dev = analyze_batch_handle(pcm_dev, Gmax, sample_rate,
                                              align=MDCT_ALIGN)
    else:
        rl_dev = X.new_zeros(B * nch, Gmax, 21)
        rs_dev = X.new_zeros(B * nch, Gmax, 3, 12)
    del pcm_dev

    # ---- MS decision from device energies -------------------------------
    phases.start("energies")
    e_m, e_s, e_gc = vloop_device.to_host(_energies(X, nch))
    e_gc = e_gc.astype(np.float64)                         # [B, nch, G]
    ms_s = []
    msg_b = np.zeros((B, Gmax), bool)
    for s in range(B):
        n_frames = G_s[s] // 2
        ms_f = np.zeros(n_frames, bool)
        if nch == 2 and joint_stereo:
            em = e_m[s, : G_s[s]].reshape(n_frames, 2).sum(1)
            es = e_s[s, : G_s[s]].reshape(n_frames, 2).sum(1)
            ms_f = es < 0.5 * em
            msg_b[s, : G_s[s]] = np.repeat(ms_f, 2)
        ms_s.append(ms_f)

    # ---- device prep: MS butterfly + xmin rows (stay on device) ---------
    # row id in the padded layout: (b*Gmax + g)*nch + c
    phases.start("prep")
    bt_pad = np.zeros((B, Gmax, nch), np.int64)
    for s in range(B):
        bt_pad[s, : G_s[s]] = bts_s[s][:, None]
    short_row = (bt_pad.reshape(-1) == 2)
    rows_dev, xminl_dev, xmins_dev = _prep(
        tables, X, nch, torch.from_numpy(msg_b).to(device), rl_dev, rs_dev,
        torch.from_numpy(short_row).to(device))
    del X, rl_dev, rs_dev

    # valid-row ids (skips pad granules), aligned with the frame-major gc
    # order the mux consumes
    vid_parts = []
    for s in range(B):
        g = np.arange(G_s[s])
        vid_parts.append(((s * Gmax + g)[:, None] * nch
                          + np.arange(nch)).ravel())
    vid = np.concatenate(vid_parts)
    offs = np.cumsum([0] + [G_s[s] * nch for s in range(B)])
    n_gc = int(offs[-1])
    bt_all = np.concatenate([np.repeat(bts_s[s], nch) for s in range(B)])

    # ---- pass-A budgets: per-stream pessimistic reservoir walk ----------
    phases.start("passA_walk")
    cap_s, base_s, loud_s, feed_s, granted_s = [], [], [], [], []
    for s in range(B):
        n_frames = G_s[s] // 2
        sizer = FrameSizer(sample_rate, bitrate * 1000)
        fsizes = [sizer.next() for _ in range(n_frames)]
        cap_f = np.array([frame_capacity_bits(fb, nch) for fb, _ in fsizes],
                         np.int64)
        base_f = cap_f // (2 * nch) - 8
        if reservoir:
            f_energy = e_gc[s, :, : G_s[s]].sum(0).reshape(
                n_frames, 2).sum(1) + 1e-12
            loud_f = (f_energy > 2.0 * float(np.median(f_energy))) | \
                (bts_s[s].reshape(n_frames, 2) == 2).any(1)
            base_f = np.minimum(base_f, 3900)
        else:
            loud_f = np.zeros(n_frames, bool)
        horizon = 16
        upcoming = np.zeros(n_frames, bool)
        if loud_f.any():
            nxt = np.minimum.accumulate(
                np.where(loud_f, np.arange(n_frames), 1 << 30)[::-1])[::-1]
            upcoming = (nxt - np.arange(n_frames)) <= horizon
        feed_f = np.where(loud_f | ~upcoming, 0, 64)
        if reservoir:
            granted = np.empty(n_frames, np.int64)
            res_lb = 0
            cap_res = ReservoirMux.MAX_BACK * 8
            for f in range(n_frames):
                avail = min(max(res_lb, 0), 3000)
                if loud_f[f]:
                    bud = base_f[f] + avail // (2 * nch)
                else:
                    bud = base_f[f] - feed_f[f] + (avail // 8) // (2 * nch)
                granted[f] = int(min(bud, 3900))
                res_lb = min(res_lb + cap_f[f] - 2 * nch * granted[f] - 7,
                             cap_res)
        else:
            granted = base_f.copy()
        cap_s.append(cap_f)
        base_s.append(base_f)
        loud_s.append(loud_f)
        feed_s.append(feed_f)
        granted_s.append(granted)

    # ---- device quantization --------------------------------------------
    # device emission (encoder/emit_device.py): the deferred/reservoir
    # path downloads packed bitstream bytes instead of spectra
    phases.start("passA")
    device_emit = (reservoir and cfg_emit
                   and os.environ.get("MP3TPU_DEVICE_EMIT", "1") != "0")
    from . import native_emit
    CAP = native_emit._CAP
    bits_bytes = np.zeros((n_gc, CAP), np.uint8)
    meta = np.zeros((n_gc, 6), np.int32)
    emitted = np.zeros(n_gc, bool)
    ix_a = np.zeros((n_gc, 576), np.int16)
    gg_a = np.full(n_gc, 210, np.int64)
    lsf_a = np.zeros((n_gc, 21), np.int64)
    ssf_a = np.zeros((n_gc, 3, 12), np.int64)
    sbg_a = np.zeros((n_gc, 3), np.int64)
    hbits_a = np.zeros(n_gc, np.int64)
    tsel_a = np.zeros((n_gc, 3), np.int64)
    c1t_a = np.zeros(n_gc, np.int64)

    def quantize_rows_dev(idx, budgets, light):
        """Run the device loops for the gc indices idx (0..n_gc) at the
        budgets aligned with them, one group per kind of row; the results
        stay on the device. Returns pend_list, whose entries (gc_ids, kind,
        layout, _Pending) go to finalize_pending once the caller knows
        which rows it keeps: most pass-A rows of an upgraded frame are
        re-quantized by pass B, so their spectra never need to leave the
        device.

        light=True also downloads what the pass-B planning consumes (bits
        and scalefactors) and returns ((bits, lsf, ssf), pend_list)."""
        b = budgets.astype(np.int64)
        btr = bt_all[idx]
        shaped_l = (btr != 2) & noise_shaping
        shaped_s = (btr == 2) & noise_shaping
        plain = ~shaped_l & ~shaped_s
        pend_list = []
        o_lsf = np.zeros((len(idx), 21), np.int64)
        o_ssf = np.zeros((len(idx), 3, 12), np.int64)
        o_bits = np.zeros(len(idx), np.int64)
        # long-LAYOUT rows: 0 plus start/stop 1/3 (long spectrum + long
        # sfb shaping; block_type switches the region split)
        vd = vloop_device
        for bt in (0, 1, 3):
            sel = np.nonzero(shaped_l & (btr == bt))[0]
            if not len(sel):
                continue
            args = (rows_dev, xminl_dev, vid[idx[sel]], b[sel], sample_rate)
            if light:
                (o_lsf[sel], o_bits[sel]), pend = vd.outer_rows_gathered_light(
                    *args, block_type=int(bt))
            else:
                pend = vd.outer_rows_gathered_pending(*args, block_type=int(bt))
            pend_list.append((idx[sel], "long",
                              "long" if bt == 0 else "switched", pend))
        if shaped_s.any():
            sel = np.nonzero(shaped_s)[0]
            args = (rows_dev, xmins_dev, vid[idx[sel]], b[sel], sample_rate)
            if light:
                (o_ssf[sel], o_bits[sel]), pend = \
                    vd.outer_rows_short_gathered_light(*args)
            else:
                pend = vd.outer_rows_short_gathered_pending(*args)
            pend_list.append((idx[sel], "short", "short", pend))
        if plain.any():
            for bt in np.unique(btr[plain]):
                sel = np.nonzero(plain & (btr == bt))[0]
                args = (rows_dev, vid[idx[sel]], b[sel], sample_rate, int(bt))
                if light:
                    (o_bits[sel],), pend = vd.rate_rows_gathered_light(*args)
                else:
                    pend = vd.rate_rows_gathered_pending(*args)
                lay = ("long" if bt == 0
                       else "short" if bt == 2 else "switched")
                pend_list.append((idx[sel], "rate", lay, pend))
        if light:
            return (o_bits, o_lsf, o_ssf), pend_list
        return pend_list

    def finalize_pending(pend_list, keep_mask, verify_p23=False):
        """Download the results of the rows keep_mask selects. Entries
        carry the GLOBAL gc ids of their rows.

        With device_emit on, the packed part2+part3 BYTES download
        instead of the spectra (emit_device via _Pending.emit_and_take);
        bits_bytes/meta/p23 are written directly and the host emitter is
        bypassed for these rows. verify_p23 pins the count==emit contract
        against the host-side pass-A predictions."""
        for gids, kind, layout, pend in pend_list:
            loc = np.nonzero(keep_mask[gids])[0]
            if not len(loc):
                continue
            tgt = gids[loc]
            if device_emit:
                vloop_device.take_iter_stats(pend, layout)  # telemetry
                by, m5, gg, tcols, c1, hb, sbg = pend.emit_and_take(
                    layout, kind != "rate", loc)
                bits_bytes[tgt] = by
                meta[tgt, :5] = m5
                gg_a[tgt] = gg
                tsel_a[tgt] = vloop_device._TID[tcols.astype(np.int64)]
                c1t_a[tgt] = c1
                hbits_a[tgt] = hb
                if sbg is not None:
                    sbg_a[tgt] = sbg
                # count == emit, device-to-device: the emitter's bit
                # total must equal the count's huffman bits plus the
                # scalefactor side bits its sfc implies
                sfc = m5[:, 2].astype(np.int64)
                if layout == "short":
                    sfb = 18 * (vloop._SLEN1[sfc] + vloop._SLEN2[sfc])
                else:
                    sfb = 11 * vloop._SLEN1[sfc] + 10 * vloop._SLEN2[sfc]
                assert np.array_equal(m5[:, 0].astype(np.int64),
                                      hb.astype(np.int64) + sfb), \
                    "device emitter/count drift"
                if verify_p23:  # vs the host pass-A prediction
                    assert np.array_equal(m5[:, 0].astype(np.int64),
                                          p23[tgt]), "emitter/p23 drift"
                p23[tgt] = m5[:, 0]
                emitted[tgt] = True
                continue
            raw = pend.fetch_rows(loc)
            if kind == "long":
                gg, sf, _has, ix, bits, ts, c1 = vloop_device.post_long(
                    raw, label=layout)
                ix_a[tgt], gg_a[tgt], lsf_a[tgt] = ix, gg, sf
            elif kind == "short":
                gg, sf, sbg, _has, ix, bits, ts, c1 = \
                    vloop_device.post_short(raw)
                ix_a[tgt], gg_a[tgt] = ix, gg
                ssf_a[tgt], sbg_a[tgt] = sf, sbg
            else:
                gg, _has, ix, bits, ts, c1 = vloop_device.post_rate(raw)
                ix_a[tgt], gg_a[tgt] = ix, gg
            hbits_a[tgt], tsel_a[tgt], c1t_a[tgt] = bits, ts, c1

    def p23_of(idx):
        """part2_3_length = exact huffman bits + scalefactor side bits."""
        p = hbits_a[idx].copy()
        btr = bt_all[idx]
        if noise_shaping:
            lm = btr != 2
            if lm.any():
                sfc = vloop.pick_sfc_rows(lsf_a[idx[lm]])
                p[lm] += 11 * vloop._SLEN1[sfc] + 10 * vloop._SLEN2[sfc]
            sm = btr == 2
            if sm.any():
                sfc = vloop.pick_sfc_short_rows(ssf_a[idx[sm]])
                p[sm] += 18 * (vloop._SLEN1[sfc] + vloop._SLEN2[sfc])
        return p

    idx_all = np.arange(n_gc)
    budgets_a = np.concatenate([np.repeat(granted_s[s], 2 * nch)
                                for s in range(B)])
    if reservoir:
        # pass A downloads only what the upgrade walk consumes (bits and
        # scalefactors); the spectra stay on the device until it is known
        # which rows pass B re-quantizes
        (hbits_a[:], lsf_a[:], ssf_a[:]), pend_a = \
            quantize_rows_dev(idx_all, budgets_a, light=True)
    else:
        pend_a = quantize_rows_dev(idx_all, budgets_a, light=False)
        finalize_pending(pend_a, np.ones(n_gc, bool))
        pend_a = None
    p23 = p23_of(idx_all)

    # ---- pass-B upgrade walk per stream, one batched re-quantize --------
    phases.start("passB")
    if reservoir:
        # Upgrade only frames whose budget bump is MATERIAL (> margin
        # bits per granule-channel). Pass A's reservoir walk is a lower
        # bound that loses a few bits a frame to worst-case byte-alignment
        # pessimism, so with margin=0 nearly every frame "upgrades" by a
        # few bits and gets re-quantized on the device for no audible gain.
        # Kept frames stay coded at their pass-A budget (always conformant:
        # coding under budget is legal) and their EXACT coded size feeds
        # the walk, which is what actually grows the reservoir for the loud
        # frames that need real upgrades. Genuine reclaims (quiet stretch
        # -> transient) are hundreds of bits and sail over the margin; at
        # 128 kbps stereo a skipped 96-bit bump is about 2% of a frame's
        # budget.
        margin = int(os.environ.get("MP3TPU_UPGRADE_MARGIN", "96"))
        _deltas = [] if _prof else None
        upg_idx_parts, upg_bud_parts = [], []
        for s in range(B):
            n_frames = G_s[s] // 2
            granted = granted_s[s]
            cap_f = cap_s[s]
            fsum = p23[offs[s]: offs[s + 1]].reshape(n_frames, 2 * nch).sum(1)
            final = granted.copy()
            stream_bits = 0
            placed_bytes = 0
            loud_f, base_f, feed_f = loud_s[s], base_s[s], feed_s[s]
            for f in range(n_frames):
                res = placed_bytes * 8 - stream_bits
                avail = min(max(res, 0), 3000)
                if loud_f[f]:
                    want = base_f[f] + avail // (2 * nch)
                else:
                    want = base_f[f] - feed_f[f] + (avail // 8) // (2 * nch)
                want = int(min(want, 3900))
                if _deltas is not None and want > granted[f]:
                    _deltas.append(want - granted[f])
                if want > granted[f] + margin:
                    final[f] = want
                    used = 2 * nch * want
                else:
                    used = int(fsum[f])
                stream_bits = (stream_bits + used + 7) & ~7
                placed_bytes += int(cap_f[f]) // 8
                excess = (placed_bytes - stream_bits // 8
                          - ReservoirMux.MAX_BACK)
                if excess > 0:
                    stream_bits += excess * 8
            upg_f = np.nonzero(final > granted)[0]
            if len(upg_f):
                gidx = (offs[s] + upg_f[:, None] * 2 * nch
                        + np.arange(2 * nch)).ravel()
                upg_idx_parts.append(gidx)
                upg_bud_parts.append(np.repeat(final[upg_f], 2 * nch))
                granted_s[s] = final
        keep_mask = np.ones(n_gc, bool)
        if _deltas is not None and _deltas:
            d = np.sort(np.asarray(_deltas))
            _ph['upg_want_gt_granted'] = len(d)
            _ph['upg_delta_p50'] = int(d[len(d) // 2])
            _ph['upg_delta_p90'] = int(d[(len(d) * 9) // 10])
            _ph['upg_delta_max'] = int(d[-1])
        if upg_idx_parts:
            uidx = np.concatenate(upg_idx_parts)
            keep_mask[uidx] = False
            if _prof:
                _ph['upgraded_rows'] = len(uidx)
                _ph['total_rows'] = n_gc
        pend_b = None
        if upg_idx_parts:
            pend_b = quantize_rows_dev(uidx, np.concatenate(upg_bud_parts),
                                       light=False)
        phases.start("emit")
        if pend_b is not None:
            finalize_pending(pend_a, keep_mask, verify_p23=device_emit)
            finalize_pending(pend_b, ~keep_mask)
            if not device_emit:
                p23[uidx] = p23_of(uidx)
        else:
            finalize_pending(pend_a, keep_mask, verify_p23=device_emit)
        pend_a = pend_b = None

    # ---- emission: host path for rows the device didn't emit ------------
    # (all of them with device_emit off / the eager no-reservoir path;
    # none with it on: the deferred finalize wrote bits_bytes directly)
    phases.start("emit")
    todo = np.nonzero(~emitted)[0]
    use_sf = np.full(n_gc, bool(noise_shaping))
    packed = None
    if len(todo):
        packed = native_emit.encode_rows_packed(
            ix_a[todo], bt_all[todo], use_sf[todo], lsf_a[todo], ssf_a[todo],
            tsel_a[todo], c1t_a[todo], sample_rate)
        if packed is None and on_card:
            raise RuntimeError("the C++ row emitter is unavailable or "
                               "overflowed (MP3TPU_NO_NATIVE set, or no g++)")
    if packed is not None:
        bits_bytes[todo], meta[todo] = packed
    else:
        for i in todo:
            b = int(bt_all[i])
            kw = {}
            if use_sf[i] and b != 2:
                kw = dict(long_sf=lsf_a[i])
            if use_sf[i] and b == 2:
                kw = dict(short_sf=ssf_a[i],
                          subblock_gain=tuple(int(x) for x in sbg_a[i]))
            g = encode_granule(np.asarray(ix_a[i], np.int32), int(gg_a[i]),
                               sample_rate, b, tsel=tsel_a[i],
                               c1table=int(c1t_a[i]), **kw)
            row = np.packbits(np.asarray(g.bits.bits, np.uint8))
            bits_bytes[i, : len(row)] = row
            meta[i] = (g.part2_3_length, g.big_values, g.scalefac_compress,
                       g.region0_count, g.region1_count, 0)
    # emission must agree with the predicted exact counts: this is the
    # count == emit contract the reservoir replay depends on
    assert np.array_equal(meta[:, 0].astype(np.int64), p23), \
        "emitter/count drift"

    def rows_host(gi):
        """Download the few rows a refit needs (rare overdrafts)."""
        sel = torch.from_numpy(vid[gi]).to(device)
        return rows_dev.index_select(0, sel).cpu().numpy().astype(np.float64)

    phases.start("mux")
    # ---- per-stream overdraft guard + packed mux ------------------------
    from .mux_packed import assemble_stream
    out = []
    for s in range(B):
        n_frames = G_s[s] // 2
        cap_f = cap_s[s]
        sl = slice(int(offs[s]), int(offs[s + 1]))
        stream_bits = 0
        placed_bytes = 0
        for f in range(n_frames):
            g0 = int(offs[s]) + f * 2 * nch
            need = int(p23[g0: g0 + 2 * nch].sum())
            res_now = placed_bytes * 8 - stream_bits
            if need > int(cap_f[f]) + res_now:
                avail = min(max(res_now, 0), 3000)
                bud = int(min(base_s[s][f] + avail // (2 * nch), 3900))
                gi = np.arange(g0, g0 + 2 * nch)
                rh = rows_host(gi)
                for bt in np.unique(bt_all[gi]):
                    m = np.nonzero(bt_all[gi] == bt)[0]
                    ixr, ggr = vloop.inner_rate_rows(
                        rh[m], np.full(len(m), bud, np.int64),
                        sample_rate, int(bt))
                    for j, mi in enumerate(m):
                        i = int(gi[mi])
                        g = encode_granule(ixr[j], int(ggr[j]),
                                           sample_rate, int(bt))
                        row = np.packbits(np.asarray(g.bits.bits, np.uint8))
                        bits_bytes[i] = 0
                        bits_bytes[i, : len(row)] = row
                        meta[i] = (g.part2_3_length, g.big_values,
                                   g.scalefac_compress, g.region0_count,
                                   g.region1_count, 0)
                        tsel_a[i] = g.table_select
                        c1t_a[i] = g.count1table_select
                        gg_a[i] = g.global_gain
                        sbg_a[i] = 0
                        p23[i] = g.part2_3_length
                need = int(p23[g0: g0 + 2 * nch].sum())
            stream_bits += need
            stream_bits = (stream_bits + 7) & ~7
            placed_bytes += int(cap_f[f]) // 8
            excess = placed_bytes - stream_bits // 8 - ReservoirMux.MAX_BACK
            if excess > 0:
                stream_bits += excess * 8
        body = assemble_stream(
            bits_bytes[sl], p23[sl], meta[sl, 1].astype(np.int64),
            gg_a[sl], meta[sl, 2].astype(np.int64), bt_all[sl], tsel_a[sl],
            sbg_a[sl], meta[sl, 3].astype(np.int64),
            meta[sl, 4].astype(np.int64), c1t_a[sl], ms_s[s],
            nch, sr_idx, br_idx, sample_rate, bitrate,
            require_native=on_card)
        if gapless_tag:
            xing_bytes = FrameSizer(sample_rate, bitrate * 1000).next()[0]
            xing = build_xing_frame(nch, sr_idx, br_idx, xing_bytes,
                                    n_frames=n_frames,
                                    n_bytes=len(body) + xing_bytes,
                                    encoder_delay=ENCODER_DELAY,
                                    encoder_padding=encpad_s[s])
            body = xing + body
        out.append(body)
    phases.close()
    if _prof:
        global LAST_PROFILE
        LAST_PROFILE = dict(_ph)
        print('MP3TPU_ENCODE_PROFILE',
              {k: round(v, 3) for k, v in _ph.items()}, flush=True)
    return out
