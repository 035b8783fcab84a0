"""MP3 encoder (SURVEY.md E1-E6): analysis filterbank + MDCT on the
batched transform path, psychoacoustic-informed block switching, rate
loop, Huffman coding and CBR mux. Produces ISO 11172-3 conformant
MPEG-1 Layer III streams with a Xing/LAME gapless tag so that
decode(encode(x)) is sample-aligned with x.

Counterpart of mp3tpu.encoder. encode_pcm's host path (float64 numpy) is the
JAX package's code and gives its bytes; the device paths (device_transform,
device_loops) are torch and run on `device`.
"""
from __future__ import annotations

import numpy as np

from ..container.frames import BITRATES_V1_L3
from .huffcode import encode_granule
from .mux import (FrameSizer, ReservoirMux, build_frame, build_xing_frame,
                  frame_capacity_bits)
from .psymodel import align_to_mdct, block_type_sequence, get_model
from .quantize import (inner_rate_loop, outer_distortion_loop,
                       outer_distortion_loop_short)
from .transform import granule_spectra

SPF = 576
ENCODER_DELAY = 528   # analysis+MDCT chain delay minus the decoder's 529
SR_IDX = {44100: 0, 48000: 1, 32000: 2}

from functools import lru_cache

from ..tables.sfb import LONG

# reduceat edges for long-band energies (22 segments, last runs to 576)
LONG_EDGES = {sr: LONG[sr][:22] for sr in LONG}


@lru_cache(maxsize=None)
def _short_flat_map(sample_rate: int) -> np.ndarray:
    """transmitted line -> window*13 + short_sfb (band_map slot - 22)."""
    from ..tables import maps as tmaps
    return (tmaps.band_map(sample_rate, tmaps.FLAVOR_SHORT) - 22).astype(np.int64)


def encode_pcm(pcm: np.ndarray, sample_rate: int, bitrate: int | None = None,
               gapless_tag: bool | None = None,
               short_blocks: bool | None = None,
               joint_stereo: bool | None = None,
               noise_shaping: bool | None = None,
               device_transform: bool | None = None, reservoir: bool = True,
               vbr_quality: int | None = None,
               device_loops: bool | None = None, device="cuda") -> bytes:
    """Encode float PCM [-1, 1], shape [n] or [n, ch], to MP3 bytes.

    MPEG-1 rates (44100/48000/32000); 1 or 2 channels. CBR at `bitrate`
    kbps; mid/side joint stereo is chosen per frame when the side
    channel is weak; the first frame is a Xing/LAME metadata frame.
    noise_shaping (default on) enables the outer distortion loop:
    per-band scalefactors driven by the psychoacoustic model 2's
    masking thresholds (1024-pt FFT unpredictability tonality, bark
    spreading, pre-echo control — see psymodel.py), for both long and
    short blocks. It trades plain SNR for masked-noise placement;
    disable it for maximum plain-SNR encodes.
    device_transform runs E1+E2 (analysis filterbank + MDCT) in float32
    torch on `device` as one batched call (SURVEY.md §3.4); None (default)
    resolves to True when `device` is not the CPU and the stream has at
    least 256 granules, else False (the float64 numpy reference path).
    reservoir enables bit-reservoir coding (granules borrow capacity
    that quieter earlier granules left unused, ISO §2.4.1.7).
    vbr_quality (0 best .. 9 smallest) switches to constant-quality VBR:
    each granule is quantized at a fixed quality step and every frame
    gets the smallest bitrate that fits; the Xing frame carries a real
    byte TOC for seeking.
    device_loops routes the WHOLE encode through the batched device
    encoder at B=1 (encoder/batch.py: spectra stay device-resident
    from transform through the rate loops); None (default) resolves to
    True when `device` is not the CPU, the stream is long enough to
    amortize the launches (>= 128 granules, about 1.7 s of audio), and
    the request is CBR. False forces the f64 host lockstep path: the
    bit-reproducible reference whose output does not depend on the
    device.
    device ("cuda" by default) is where the device paths run; with "cpu"
    the unset routes resolve to the host path.
    """
    import torch
    on_card = torch.device(device).type != "cpu"
    if sample_rate not in SR_IDX:
        raise ValueError(f"unsupported sample rate {sample_rate} "
                         f"(MPEG-1: 44100/48000/32000)")
    # unset parameters fall back to the active EncodeConfig (SURVEY.md
    # §5.6 — same layering as decode_file)
    from ..config import get_active
    ecfg = get_active().encode
    bitrate = ecfg.bitrate if bitrate is None else bitrate
    gapless_tag = ecfg.gapless_tag if gapless_tag is None else gapless_tag
    short_blocks = ecfg.short_blocks if short_blocks is None else short_blocks
    joint_stereo = ecfg.joint_stereo if joint_stereo is None else joint_stereo
    noise_shaping = (ecfg.noise_shaping if noise_shaping is None
                     else noise_shaping)
    if device_loops is None and ecfg.device_loops != "auto":
        device_loops = ecfg.device_loops == "on"
    if bitrate not in BITRATES_V1_L3:
        raise ValueError(f"unsupported bitrate {bitrate}")
    pcm = np.asarray(pcm, np.float64)
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    n, nch = pcm.shape
    if nch > 2:
        raise ValueError("at most 2 channels")

    # flush so the decoded+trimmed output covers all n input samples
    total_needed = n + ENCODER_DELAY + 529
    G = -(-total_needed // SPF)
    G += G & 1  # whole frames (2 granules)
    enc_padding = G * SPF - ENCODER_DELAY - n
    if device_loops is None:
        device_loops = (on_card and G >= 128 and vbr_quality is None
                        and device_transform is not False)
    if device_loops:
        if vbr_quality is not None:
            raise ValueError("device_loops supports CBR only "
                             "(vbr_quality must be None)")
        from .batch import encode_batch
        return encode_batch([pcm], sample_rate, bitrate=bitrate,
                            gapless_tag=gapless_tag,
                            short_blocks=short_blocks,
                            joint_stereo=joint_stereo,
                            noise_shaping=noise_shaping,
                            reservoir=reservoir, device=device)[0]
    padded = np.zeros((G * SPF, nch))
    padded[:n] = pcm

    sr_idx = SR_IDX[sample_rate]
    br_idx = BITRATES_V1_L3.index(bitrate)
    # transient labels and masking analysis run on the MDCT-aligned copy
    # (psymodel.MDCT_ALIGN): granule g's spectrum holds time content
    # delayed by the analysis chain, so unshifted labels switch windows
    # one granule early and leave the attack granule long (= pre-echo)
    aligned = align_to_mdct(padded)
    bts = block_type_sequence(aligned, sample_rate) if short_blocks \
        else np.zeros(G, np.int64)

    # E1+E2 transform: all channels in one device batch, or numpy f64.
    # Default: the device when it is not the CPU (SURVEY.md §3.4) AND the
    # signal is long enough to amortize the fixed costs of staging, the
    # launches and the spectra's download (batch throughput lives in
    # encode_batch, not here); the f64 numpy reference path otherwise.
    if device_transform is None:
        device_transform = on_card and G >= 256
    if device_transform:
        from .device import granule_spectra_device_batch
        xr = granule_spectra_device_batch(
            padded.T.copy(), np.tile(bts, (nch, 1)), sample_rate,
            device=device)
        xr = xr.transpose(1, 0, 2)                 # [G, nch, 576]
    else:
        xr = np.stack([granule_spectra(padded[:, c], bts, sample_rate)
                       for c in range(nch)], axis=1)

    # psychoacoustic model 2: per-channel threshold/energy ratios
    # (FFT-domain, dimensionless — applied to MDCT band energies below)
    psy = None
    if noise_shaping and vbr_quality is None:
        model = get_model(sample_rate)
        psy = [model.analyze(aligned[:, c], bts) for c in range(nch)]

    vbr = vbr_quality is not None
    if vbr:
        reservoir = True  # VBR uses the stream mux
    sizer = FrameSizer(sample_rate, bitrate * 1000)
    mux = ReservoirMux(nch, sr_idx, br_idx,
                       FrameSizer(sample_rate, bitrate * 1000)) if reservoir else None
    frames = []
    n_frames = G // 2
    s2 = 1.0 / np.sqrt(2.0)
    # per-granule energy for the loud/transient frame heuristic
    g_energy = (xr ** 2).sum(axis=(1, 2)) + 1e-12
    from . import vloop
    from .quantize import IX_MAX
    from .vcount import count_bits_rows, count_bits_rows_full

    # ---- per-frame mid/side decision, vectorized (MS when the side
    # channel is weak; the decoder's 1/sqrt2 butterfly is orthogonal, so
    # its exact inverse is applied here)
    ms_f = np.zeros(n_frames, bool)
    if nch == 2 and joint_stereo:
        mid = (xr[:, 0] + xr[:, 1]) * s2
        side = (xr[:, 0] - xr[:, 1]) * s2
        e_m = (mid ** 2).sum(1).reshape(n_frames, 2).sum(1)
        e_s = (side ** 2).sum(1).reshape(n_frames, 2).sum(1)
        ms_f = e_s < 0.5 * e_m
        msg = np.repeat(ms_f, 2)
        xr[msg, 0], xr[msg, 1] = mid[msg], side[msg]

    # ---- psymodel per-gc allowed-noise rows (threshold/energy ratio x
    # band energy; under mid/side the conservative elementwise min of
    # both channels' masking applies to both mid and side)
    if psy is not None:
        en_l = np.add.reduceat(xr * xr, LONG_EDGES[sample_rate],
                               axis=2)[:, :, :21]              # [G,nch,21]
        ratio_l = np.stack([p.ratio_l for p in psy], 1)        # [G,nch,21]
        flat = _short_flat_map(sample_rate)
        ind39 = np.zeros((576, 39))
        ind39[np.arange(576), np.minimum(flat, 38)] = 1.0
        en_s = (xr.reshape(-1, 576) ** 2 @ ind39).reshape(
            G, nch, 3, 13)[:, :, :, :12]
        ratio_s = np.stack([p.ratio_s for p in psy], 1)        # [G,nch,3,12]
        if nch == 2:
            msg = np.repeat(ms_f, 2)
            both_l = np.minimum(ratio_l[:, 0], ratio_l[:, 1])[:, None]
            both_s = np.minimum(ratio_s[:, 0], ratio_s[:, 1])[:, None]
            ratio_l = np.where(msg[:, None, None], both_l, ratio_l)
            ratio_s = np.where(msg[:, None, None, None], both_s, ratio_s)
        xmin_l = (ratio_l * en_l).reshape(-1, 21)
        xmin_s = (ratio_s * en_s).reshape(-1, 3, 12)

    def quantize_gc_rows(gc_idx: np.ndarray, budgets: np.ndarray):
        """Lockstep phase: quantize the given granule-channel rows at
        the given per-row budgets. Returns dict of per-row results."""
        rows = xr.reshape(-1, 576)[gc_idx]
        bt_rows = np.repeat(bts, nch)[gc_idx]
        out_ix = np.zeros((len(gc_idx), 576), np.int32)
        out_gg = np.full(len(gc_idx), 210, np.int64)
        out_lsf = np.zeros((len(gc_idx), 21), np.int64)
        out_ssf = np.zeros((len(gc_idx), 3, 12), np.int64)
        out_sbg = np.zeros((len(gc_idx), 3), np.int64)
        if psy is not None:
            smask = bt_rows == 2
            pmask = np.zeros(len(gc_idx), bool)
        else:
            smask = np.zeros(len(gc_idx), bool)
            pmask = np.ones(len(gc_idx), bool)
        if psy is not None:
            # long-LAYOUT rows (0 plus start/stop 1/3 — they keep the
            # long spectrum and long sfb partition) all get the shaped
            # outer loop; block_type only switches the counter's region
            # split. Grouped per type because the split is per-call.
            for bt in (0, 1, 3):
                sel = np.nonzero(bt_rows == bt)[0]
                if len(sel):
                    ix, gg, lsf = vloop.outer_rows(
                        rows[sel], xmin_l[gc_idx[sel]], budgets[sel],
                        sample_rate, block_type=bt)
                    out_ix[sel], out_gg[sel], out_lsf[sel] = ix, gg, lsf
        if smask.any():
            sel = np.nonzero(smask)[0]
            ix, gg, ssf, sbg = vloop.outer_rows_short(
                rows[sel], xmin_s[gc_idx[sel]], budgets[sel], sample_rate)
            out_ix[sel], out_gg[sel] = ix, gg
            out_ssf[sel], out_sbg[sel] = ssf, sbg
        if pmask.any():
            # plain rate loop, grouped by block type (window-switched
            # rows use their type's fixed region split in the count)
            for bt in (0, 1, 2, 3):
                sel = np.nonzero(pmask & (bt_rows == bt))[0]
                if len(sel):
                    ix, gg = vloop.inner_rate_rows(rows[sel], budgets[sel],
                                                   sample_rate, bt)
                    out_ix[sel], out_gg[sel] = ix, gg
        return out_ix, out_gg, out_lsf, out_ssf, out_sbg, bt_rows

    def emit_gc(ix, gg, lsf, ssf, sbg, bt, tsel=None, c1t=None):
        if psy is not None and bt != 2:
            return encode_granule(ix, int(gg), sample_rate, int(bt),
                                  long_sf=lsf, tsel=tsel, c1table=c1t)
        if psy is not None and bt == 2:
            return encode_granule(ix, int(gg), sample_rate, 2, short_sf=ssf,
                                  subblock_gain=tuple(int(s) for s in sbg),
                                  tsel=tsel, c1table=c1t)
        return encode_granule(ix, int(gg), sample_rate, int(bt),
                              tsel=tsel, c1table=c1t)

    if vbr:
        # ---- constant-quality VBR: quantize ALL granules at the fixed
        # quality step in one lockstep batch, then walk frames picking
        # the smallest bitrate that fits (SURVEY.md §3.4)
        rows = xr.reshape(-1, 576)
        amax = np.abs(rows).max(1)
        gg_v = np.full(len(rows), 210, np.int64)
        pos = amax > 0
        while True:
            up = pos & ((amax * 2.0 ** (-(gg_v - 210) / 4.0)) ** 0.75 > IX_MAX)
            if not up.any():
                break
            gg_v[up] += 1
        while True:
            dn = pos & (gg_v > 0) & (
                (amax * 2.0 ** (-(gg_v - 1 - 210) / 4.0)) ** 0.75 <= IX_MAX)
            if not dn.any():
                break
            gg_v[dn] -= 1
        gg_v = np.minimum(gg_v + 12 + 3 * vbr_quality, 255)
        p34 = np.abs(rows) ** 0.75
        ix_v = vloop.quantize_rows(p34, np.sign(rows), gg_v)
        bt_rows = np.repeat(bts, nch)
        bits_v = np.zeros(len(rows), np.int64)
        tsel_v = np.zeros((len(rows), 3), np.int64)
        c1t_v = np.zeros(len(rows), np.int64)
        for bt in (0, 1, 2, 3):
            m = bt_rows == bt
            if m.any():
                bits_v[m], sel = count_bits_rows_full(ix_v[m], sample_rate,
                                                      int(bt))
                tsel_v[m, 0] = sel["t0"]
                tsel_v[m, 1] = sel["t1"]
                tsel_v[m, 2] = sel["t2"]
                c1t_v[m] = sel["c1table"]
        for f in range(n_frames):
            gc0 = f * 2 * nch
            idx = np.arange(gc0, gc0 + 2 * nch)
            need = int(np.minimum(bits_v[idx], 4000).sum())
            chosen = 14
            for bi in range(1, 15):
                fb_try = (1152 // 8) * BITRATES_V1_L3[bi] * 1000 // sample_rate
                cap = frame_capacity_bits(fb_try, nch)
                if cap + min(mux.reservoir_bits, 2000) >= need + 64:
                    chosen = bi
                    break
            fb_sel = (1152 // 8) * BITRATES_V1_L3[chosen] * 1000 // sample_rate
            cap = frame_capacity_bits(fb_sel, nch)
            refit = (bits_v[gc0: gc0 + 2 * nch] > 4000).any() or \
                need > cap + mux.reservoir_bits
            if refit:
                # re-fit the whole frame to the selected capacity in one
                # lockstep call (the scalar per-gc loop was the VBR
                # bottleneck on dense content)
                idx = np.arange(gc0, gc0 + 2 * nch)
                budget = np.full(2 * nch, cap // (2 * nch) - 8, np.int64)
                for bt in np.unique(bt_rows[idx]):
                    m = np.nonzero(bt_rows[idx] == bt)[0]
                    ixr, ggr = vloop.inner_rate_rows(
                        rows[idx[m]], budget[m], sample_rate, int(bt))
                    ix_v[idx[m]], gg_v[idx[m]] = ixr, ggr
            granules = []
            for gr in range(2):
                out_row = []
                for c in range(nch):
                    i = gc0 + gr * nch + c
                    ix, gg, bt = ix_v[i], int(gg_v[i]), int(bt_rows[i])
                    ts = None if refit else tsel_v[i]
                    c1 = None if refit else int(c1t_v[i])
                    out_row.append(encode_granule(ix, gg, sample_rate, bt,
                                                  tsel=ts, c1table=c1))
                granules.append(out_row)
            mux.add_frame(granules, bool(ms_f[f]), br_idx=chosen,
                          frame_bytes=fb_sel, pad=0)
    else:
        # ---- CBR two-phase (SURVEY.md §7.5-5: batch the math, keep loop
        # control on host). Phase A: every QUIET frame's granules at the
        # base budget in ONE lockstep batch (quiet frames draw nothing
        # from the reservoir, making their budgets reservoir-independent).
        # Phase B: walk frames through the mux; loud/transient frames
        # draw min(reservoir, 3000) — known only at their turn — and are
        # re-quantized then (a small lockstep call each, ~10-20% of
        # frames).
        fsizes = [sizer.next() for _ in range(n_frames)]
        cap_f = np.array([frame_capacity_bits(fb, nch) for fb, _ in fsizes],
                         np.int64)
        base_f = cap_f // (2 * nch) - 8
        n_gc = 2 * nch * n_frames
        bt_all = np.repeat(bts, nch)
        if mux is not None:
            f_energy = g_energy.reshape(n_frames, 2).sum(1)
            loud_f = (f_energy > 2.0 * float(np.median(f_energy))) | \
                (bts.reshape(n_frames, 2) == 2).any(1)
            base_f = np.minimum(base_f, 3900)
        else:
            loud_f = np.zeros(n_frames, bool)

        RESERVE_FEED = 64   # bits/gc quiet frames leave for the reservoir
        # feed only quiet frames that have a loud frame coming up soon —
        # all-quiet content keeps its full budget (no tax for a reservoir
        # nobody will draw)
        horizon = 16
        upcoming = np.zeros(n_frames, bool)
        if loud_f.any():
            nxt = np.minimum.accumulate(
                np.where(loud_f, np.arange(n_frames), 1 << 30)[::-1])[::-1]
            # nxt[f] = index of the next loud frame at/after f (reversed
            # cummin of loud indices); 1<<30 when none remain
            upcoming = (nxt - np.arange(n_frames)) <= horizon
        feed_f = np.where(loud_f | ~upcoming, 0, RESERVE_FEED)

        # ---- two-pass deterministic bit allocation (SURVEY.md §7.5-5:
        # batch the math, keep loop control on host):
        #   pass A: budgets from a PESSIMISTIC reservoir lower bound —
        #     every frame is guaranteed to leave cap - 2nch*budget - 7
        #     bits of slack because the rate loop never exceeds its
        #     budget — so every budget is known up front and ALL
        #     granules quantize in ONE lockstep batch;
        #   pass B: the coded size of every pass-A granule is known
        #     EXACTLY (vcount == emission bit-for-bit), so one exact
        #     reservoir replay reveals the real headroom (the rate
        #     loop's quantization undershoot), and frames whose policy
        #     budget grew re-quantize in ONE more batch (margin-capped
        #     draws keep them safe);
        #   emission: a final overdraft check per frame (rarely fires)
        #     re-fits against the true mux reservoir.

        def policy_at(f: int, avail: int) -> int:
            """Frame f's per-gc budget given borrowable reservoir bits:
            loud/transient frames draw up to 3000; quiet frames take a
            small trickle (draw//8), net of any reservoir feed."""
            avail = min(max(avail, 0), 3000)
            if loud_f[f]:
                bud = base_f[f] + avail // (2 * nch)
            else:
                bud = base_f[f] - feed_f[f] + (avail // 8) // (2 * nch)
            return int(min(bud, 3900))

        def predict_p23(ix_rows, lsf_rows, ssf_rows):
            """Exact part2_3_length per row (huffman + scalefactor bits)
            — matches encode_granule's emitted length bit-for-bit — plus
            the per-region table selections for emission reuse."""
            p23 = np.zeros(n_gc, np.int64)
            tsel = np.zeros((n_gc, 3), np.int64)
            c1t = np.zeros(n_gc, np.int64)
            for bt in (0, 1, 2, 3):
                m = bt_all == bt
                if m.any():
                    bits, sel = count_bits_rows_full(ix_rows[m], sample_rate,
                                                     int(bt))
                    p23[m] = bits
                    tsel[m, 0] = sel["t0"]
                    tsel[m, 1] = sel["t1"]
                    tsel[m, 2] = sel["t2"]
                    c1t[m] = sel["c1table"]
            if psy is not None:
                lm = bt_all != 2
                if lm.any():
                    sfc = vloop.pick_sfc_rows(lsf_rows[lm])
                    p23[lm] += 11 * vloop._SLEN1[sfc] + 10 * vloop._SLEN2[sfc]
                sm = bt_all == 2
                if sm.any():
                    sfc = vloop.pick_sfc_short_rows(ssf_rows[sm])
                    p23[sm] += 18 * (vloop._SLEN1[sfc] + vloop._SLEN2[sfc])
            return p23, tsel, c1t

        if mux is not None:
            granted = np.empty(n_frames, np.int64)
            res_lb = 0
            cap_res = ReservoirMux.MAX_BACK * 8
            for f in range(n_frames):
                bud = policy_at(f, res_lb)
                granted[f] = bud
                res_lb = min(res_lb + cap_f[f] - 2 * nch * bud - 7, cap_res)
        else:
            granted = base_f.copy()   # no reservoir: plain capacity share
        ix_a, gg_a, lsf_a, ssf_a, sbg_a, _ = quantize_gc_rows(
            np.arange(n_gc), np.repeat(granted, 2 * nch))

        tsel_a = c1t_a = None
        if mux is not None:
            # upgrade pass: a sequential ARITHMETIC walk (no quantizing
            # inside) allocates the real headroom the pass-A bound
            # missed. Untouched frames advance the replay by their exact
            # coded bits; a frame whose policy budget grew is assigned
            # that budget and pessimistically assumed to spend all of it
            # — so the walk's reservoir is a lower bound on the real one
            # and every draw it grants is safe. Then ONE batch
            # re-quantizes all upgraded frames.
            p23, tsel_a, c1t_a = predict_p23(ix_a, lsf_a, ssf_a)
            fsum = p23.reshape(n_frames, 2 * nch).sum(1)
            final = granted.copy()
            stream_bits = 0
            placed_bytes = 0
            for f in range(n_frames):
                res = placed_bytes * 8 - stream_bits
                want = policy_at(f, res)
                if want > granted[f]:
                    final[f] = want
                    used = 2 * nch * want       # pessimistic: full budget
                else:
                    used = int(fsum[f])         # exact pass-A bits
                stream_bits = (stream_bits + used + 7) & ~7
                placed_bytes += int(cap_f[f]) // 8
                excess = (placed_bytes - stream_bits // 8
                          - ReservoirMux.MAX_BACK)
                if excess > 0:
                    stream_bits += excess * 8
            upg_f = np.nonzero(final > granted)[0]
            if len(upg_f):
                idx = (upg_f[:, None] * 2 * nch + np.arange(2 * nch)).ravel()
                ix_w, gg_w, lsf_w, ssf_w, sbg_w, _ = quantize_gc_rows(
                    idx, np.repeat(final[upg_f], 2 * nch))
                ix_a[idx], gg_a[idx] = ix_w, gg_w
                lsf_a[idx], ssf_a[idx], sbg_a[idx] = lsf_w, ssf_w, sbg_w
                granted = final
                p23, tsel_a, c1t_a = predict_p23(ix_a, lsf_a, ssf_a)

        for f in range(n_frames):
            frame_bytes, padbit = fsizes[f]
            gc0 = f * 2 * nch
            refit = False
            if mux is not None:
                # exact overdraft guard against the true mux reservoir
                need = int(p23[gc0: gc0 + 2 * nch].sum())
                res_now = mux.reservoir_bits
                if need > int(cap_f[f]) + res_now:
                    refit = True
                    idx = np.arange(gc0, gc0 + 2 * nch)
                    bud = policy_at(f, res_now)
                    ix_w, gg_w, lsf_w, ssf_w, sbg_w, _ = quantize_gc_rows(
                        idx, np.full(2 * nch, bud, np.int64))
                    ix_a[idx], gg_a[idx] = ix_w, gg_w
                    lsf_a[idx], ssf_a[idx], sbg_a[idx] = lsf_w, ssf_w, sbg_w
            granules = []
            for gr in range(2):
                chs = []
                for c in range(nch):
                    i = gc0 + gr * nch + c
                    ts = None if (refit or tsel_a is None) else tsel_a[i]
                    c1 = None if (refit or c1t_a is None) else int(c1t_a[i])
                    chs.append(emit_gc(ix_a[i], gg_a[i], lsf_a[i], ssf_a[i],
                                       sbg_a[i], int(bt_all[i]),
                                       tsel=ts, c1t=c1))
                granules.append(chs)
            if mux is not None:
                mux.add_frame(granules, bool(ms_f[f]))
            else:
                frames.append(build_frame(granules, nch, sr_idx, br_idx,
                                          frame_bytes, padbit,
                                          ms=bool(ms_f[f])))

    out = mux.finish() if mux is not None else b"".join(frames)
    if gapless_tag:
        xing_bytes = FrameSizer(sample_rate, bitrate * 1000).next()[0]
        toc = None
        if vbr and mux is not None:
            sizes = np.asarray([fr[2] for fr in mux.frames], np.float64)
            cum = np.concatenate([[0.0], np.cumsum(sizes)])
            total = max(cum[-1], 1.0)
            marks = (np.arange(100) / 100.0) * len(sizes)
            toc = bytes(np.clip(
                np.interp(marks, np.arange(len(cum)), cum) / total * 256.0,
                0, 255).astype(np.uint8))
        xing = build_xing_frame(nch, sr_idx, br_idx, xing_bytes,
                                n_frames=n_frames,
                                n_bytes=len(out) + xing_bytes,
                                encoder_delay=ENCODER_DELAY,
                                encoder_padding=enc_padding, toc=toc)
        out = xing + out
    return out


def encode_batch(pcms, sample_rate: int | None = None, **kwargs) -> list:
    """Batched multi-stream encode (the aggregate-throughput path):
    transforms, psymodel and the rate/distortion loops batch across ALL
    streams on device; see encoder.batch for the architecture. pcms
    may be a DecodedBatch handle (device-resident transcode; the
    sample rate is then inferred from the handle)."""
    from .batch import encode_batch as _impl
    return _impl(pcms, sample_rate, **kwargs)
