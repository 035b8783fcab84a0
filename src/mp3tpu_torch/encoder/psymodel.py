"""Psychoacoustic model 2 (SURVEY.md E3) — ISO 11172-3 Annex D.

The real PM2 chain, vectorized over granules:

  1024-pt Hann FFT per granule (hop 576) -> magnitude r, phase f
  -> magnitude/phase prediction from the two previous granules
  -> unpredictability c(w) (0 = perfectly predictable = tonal)
  -> ~1/3-bark partition energies eb and weighted unpredictability cb
  -> bark-domain spreading (Schroeder spreading function, row-normalized)
  -> tonality index tb = -0.299 - 0.43 ln(cb), clamped [0,1]
  -> SNR offset tb*TMN(29 dB) + (1-tb)*NMT(6 dB), minval floor
  -> partition threshold nb = ecb * 10^(-SNR/10)
  -> pre-echo control: nb limited by the previous granules' thresholds
     (nb <= 2*nb[g-1], 16*nb[g-2]) and floored at the absolute threshold
  -> mapped to scalefactor bands as *threshold/energy ratios* so the
     outer loop applies them to MDCT band energies (xmin = ratio * en),
     sidestepping FFT<->MDCT scale calibration.

Short blocks get 3 x 256-pt FFTs per granule with their own partition
set and inter-window pre-echo limiting (no tonality refinement — the
short analysis window is too coarse for the phase predictor, so a fixed
mid-tonality offset is used, as in the spec's short path).

Transient-driven window switching (`block_type_sequence`) is unchanged
from v1 and feeds E2 directly; `masking_thresholds` remains as the
simple band-energy fallback API.

Copy of mp3tpu.encoder.psymodel, kept in the port so that it imports nothing of
the JAX package; the code is the same.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from ..tables.sfb import LONG, SHORT

SPF = 576
NFFT_L = 1024
NFFT_S = 256
TMN_DB = 29.0   # tone-masking-noise offset
NMT_DB = 6.0    # noise-masking-tone offset
SNR_S_DB = 14.5  # fixed short-block offset (mid tonality)
RPELEV1 = 2.0   # pre-echo: vs previous granule/window threshold
RPELEV2 = 16.0  # pre-echo: vs the one before

# The E1+E2 analysis chain delays content: polyphase group delay
# ((512-32)/2 = 240) + MDCT half-window (16 subband steps x 32 + centering
# = 288), so granule g's MDCT spectrum holds the time range
# [g*576 - 528, (g+1)*576 - 528). Psychoacoustic analysis and transient
# labels must be computed on a 528-sample-delayed copy of the signal or
# every block-switch/threshold decision lands one granule early (measured:
# attack energy of an onset at granule-offset 219 appears in MDCT granule
# g+1, which the unshifted labeler marked STOP — the pre-echo defect).
MDCT_ALIGN = 528


def align_to_mdct(pcm: np.ndarray) -> np.ndarray:
    """Delay `pcm` ([n] or [n, ch]) by MDCT_ALIGN samples so that
    time-granule indexing matches where content lands in MDCT granules."""
    out = np.zeros_like(pcm)
    out[MDCT_ALIGN:] = pcm[:-MDCT_ALIGN]
    return out


def _bark(f_hz: np.ndarray) -> np.ndarray:
    return 13.0 * np.arctan(0.00076 * f_hz) + \
        3.5 * np.arctan((f_hz / 7500.0) ** 2)


def _ath_db(f_hz: np.ndarray) -> np.ndarray:
    """Absolute threshold in quiet, dB SPL (Terhardt's approximation),
    clamped at full scale (96 dB) — the formula diverges at the band
    edges (sub-20 Hz and >16 kHz) where 'inaudible at any producible
    level' is the only meaning the clamp discards."""
    f = np.maximum(f_hz, 10.0) / 1000.0
    return np.minimum(3.64 * f ** -0.8
                      - 6.5 * np.exp(-0.6 * (f - 3.3) ** 2)
                      + 1e-3 * f ** 4, 96.0)


def _partitions(nbins: int, freqs: np.ndarray, max_width_bark: float = 0.34):
    """Group FFT bins into ~1/3-bark calculation partitions.

    Returns (part_of_bin int[nbins], n_parts, bark_center[n_parts])."""
    bark = _bark(freqs)
    part = np.zeros(nbins, np.int32)
    p = 0
    start_bark = bark[0]
    for k in range(1, nbins):
        if bark[k] - start_bark > max_width_bark:
            p += 1
            start_bark = bark[k]
        part[k] = p
    n = p + 1
    centers = np.array([bark[part == i].mean() for i in range(n)])
    return part, n, centers


def _spreading(centers: np.ndarray) -> np.ndarray:
    """Row-normalized Schroeder spreading matrix [maskee, masker].

    S[i,j] = weight of masker partition j on maskee partition i, from
    the Annex-D spreading function; rows sum to 1 so the spread energy
    ecb = S @ eb stays on the eb scale."""
    dz = centers[:, None] - centers[None, :]   # maskee - masker bark dist
    tmpx = 1.05 * dz
    x = 8.0 * np.minimum((tmpx - 0.5) ** 2 - 2.0 * (tmpx - 0.5), 0.0)
    tmpy = 15.811389 + 7.5 * (tmpx + 0.474) - \
        17.5 * np.sqrt(1.0 + (tmpx + 0.474) ** 2)
    s = np.where(tmpy <= -100.0, 0.0, 10.0 ** ((x + tmpy) / 10.0))
    return s / np.maximum(s.sum(axis=1, keepdims=True), 1e-30)


def _sfb_weights(part_of_bin: np.ndarray, n_parts: int, freqs: np.ndarray,
                 band_edges_hz: np.ndarray) -> np.ndarray:
    """W [n_parts, n_sfb]: fraction of partition p's bins lying in sfb b
    (threshold/energy mass is moved from partitions to scalefactor
    bands by bin count)."""
    n_sfb = len(band_edges_hz) - 1
    w = np.zeros((n_parts, n_sfb))
    sfb_of_bin = np.clip(
        np.searchsorted(band_edges_hz, freqs, "right") - 1, 0, n_sfb - 1)
    for p in range(n_parts):
        bins = sfb_of_bin[part_of_bin == p]
        if len(bins):
            cnt = np.bincount(bins, minlength=n_sfb)
            w[p] = cnt / len(bins)
    return w


@dataclass
class PsyOutput:
    """Per-granule threshold/energy ratios, FFT-domain (dimensionless).

    xmin for the outer loop = ratio * (MDCT band energy)."""
    ratio_l: np.ndarray    # [G, 21]
    ratio_s: np.ndarray    # [G, 3, 12]
    nb_l: np.ndarray       # [G, n_parts_l] partition thresholds (test hook)
    tonality: np.ndarray   # [G, n_parts_l]


class PsyModel:
    """Psychoacoustic model 2 for one sample rate (tables precomputed)."""

    def __init__(self, sample_rate: int):
        self.sr = sample_rate
        fl = np.arange(NFFT_L // 2 + 1) * sample_rate / NFFT_L
        fs = np.arange(NFFT_S // 2 + 1) * sample_rate / NFFT_S
        self.part_l, self.np_l, cl = _partitions(len(fl), fl)
        self.part_s, self.np_s, cs = _partitions(len(fs), fs, 0.6)
        self.spread_l = _spreading(cl)
        self.spread_s = _spreading(cs)
        # partition one-hot reducers [nbins, nparts]
        self.red_l = np.eye(self.np_l)[self.part_l]
        self.red_s = np.eye(self.np_s)[self.part_s]
        # minval: cap the tonality-driven offset at low frequencies where
        # the predictor over-reports tonality (Annex D minval table shape)
        self.minval_l = np.interp(cl, [0.0, 12.0, 26.0], [24.5, 9.0, 4.0])
        # ATH floors in FFT-energy units; full-scale sine ~ 96 dB SPL.
        # Hann-windowed full-scale sine peak-bin energy = (N/4)^2.
        off_l = 96.0 - 10.0 * np.log10((NFFT_L / 4.0) ** 2)
        off_s = 96.0 - 10.0 * np.log10((NFFT_S / 4.0) ** 2)
        self.qthr_l = np.array([
            10.0 ** ((_ath_db(fl[self.part_l == p]).min() - off_l) / 10.0)
            for p in range(self.np_l)])
        self.qthr_s = np.array([
            10.0 ** ((_ath_db(fs[self.part_s == p]).min() - off_s) / 10.0)
            for p in range(self.np_s)])
        # partition -> scalefactor-band mass (by Hz overlap via bin counts)
        line_hz = sample_rate / 1152.0   # MDCT line spacing
        self.w_l = _sfb_weights(self.part_l, self.np_l, fl,
                                LONG[sample_rate][:22] * line_hz)
        self.w_s = _sfb_weights(self.part_s, self.np_s, fs,
                                SHORT[sample_rate][:13] * line_hz * 3.0)
        self.win_l = np.hanning(NFFT_L)
        self.win_s = np.hanning(NFFT_S)

    def _frames(self, pcm: np.ndarray, nfft: int, starts: np.ndarray):
        """Gather zero-padded analysis frames [len(starts), nfft]."""
        pad = nfft
        x = np.concatenate([np.zeros(pad), pcm, np.zeros(pad)])
        idx = starts[:, None] + pad + np.arange(nfft)[None, :]
        return x[idx]

    def analyze(self, pcm: np.ndarray, block_types: np.ndarray) -> PsyOutput:
        """pcm [n] mono (one channel), block_types [G] -> PsyOutput."""
        G = len(pcm) // SPF
        g = np.arange(G)

        # ---- long analysis: 1024-pt FFT centered on each granule ----
        starts = g * SPF - (NFFT_L - SPF) // 2
        fr = self._frames(pcm, NFFT_L, starts) * self.win_l
        spec = np.fft.rfft(fr, axis=1)
        r = np.abs(spec)
        f = np.angle(spec)
        # predicted magnitude/phase from the two previous granules
        r1, r2 = np.roll(r, 1, 0), np.roll(r, 2, 0)
        f1, f2 = np.roll(f, 1, 0), np.roll(f, 2, 0)
        r1[:1] = r2[:2] = 0.0
        f1[:1] = f2[:2] = 0.0
        rp = 2.0 * r1 - r2
        fp = 2.0 * f1 - f2
        # unpredictability: euclidean distance in the complex plane over
        # the magnitude sum (0 = tonal, ~0.5+ = noise)
        num = np.sqrt((r * np.cos(f) - rp * np.cos(fp)) ** 2
                      + (r * np.sin(f) - rp * np.sin(fp)) ** 2)
        c = num / np.maximum(r + np.abs(rp), 1e-30)

        e_bin = r ** 2
        eb = e_bin @ self.red_l                      # [G, np_l]
        cb = (c * e_bin) @ self.red_l
        ecb = eb @ self.spread_l.T
        ct = cb @ self.spread_l.T
        cbn = np.clip(ct / np.maximum(ecb, 1e-30), 0.05, 1.0)
        tb = np.clip(-0.299 - 0.43 * np.log(cbn), 0.0, 1.0)
        snr_db = np.maximum(self.minval_l[None, :],
                            tb * TMN_DB + (1.0 - tb) * NMT_DB)
        nb = ecb * 10.0 ** (-snr_db / 10.0)
        # pre-echo control: a loud granule may not raise the threshold
        # far above what the just-heard (quieter) past allowed
        nb1, nb2 = np.roll(nb, 1, 0), np.roll(nb, 2, 0)
        nb1[:1] = nb2[:2] = np.inf
        nb = np.minimum(nb, np.minimum(RPELEV1 * nb1, RPELEV2 * nb2))
        nb = np.maximum(nb, self.qthr_l[None, :])

        thm_sfb = nb @ self.w_l                      # [G, 21]
        en_sfb = eb @ self.w_l
        ratio_l = thm_sfb / np.maximum(en_sfb, 1e-30)

        # ---- short analysis: 3 x 256-pt FFTs per granule ----
        short_g = np.nonzero(block_types == 2)[0]
        ratio_s = np.full((G, 3, 12), 1e9)           # unused unless short
        if len(short_g):
            sg = np.repeat(short_g, 3)
            w = np.tile(np.arange(3), len(short_g))
            starts_s = sg * SPF + w * 192 - (NFFT_S - 192) // 2
            frs = self._frames(pcm, NFFT_S, starts_s) * self.win_s
            es = np.abs(np.fft.rfft(frs, axis=1)) ** 2
            ebs = es @ self.red_s                    # [3*k, np_s]
            ecbs = ebs @ self.spread_s.T
            nbs = ecbs * 10.0 ** (-SNR_S_DB / 10.0)
            nbs = nbs.reshape(len(short_g), 3, self.np_s)
            # inter-window pre-echo: window w limited by window w-1
            # (window 0 by the long threshold of the previous granule,
            # approximated by its own value — the block switch already
            # isolated the attack)
            nbs[:, 1] = np.minimum(nbs[:, 1], RPELEV1 * nbs[:, 0])
            nbs[:, 2] = np.minimum(nbs[:, 2], RPELEV1 * nbs[:, 1])
            nbs = np.maximum(nbs, self.qthr_s[None, None, :])
            thm_s = nbs @ self.w_s[:, :12]           # [k, 3, 12]
            en_s = (ebs.reshape(len(short_g), 3, self.np_s)
                    @ self.w_s[:, :12])
            ratio_s[short_g] = thm_s / np.maximum(en_s, 1e-30)

        return PsyOutput(ratio_l=ratio_l, ratio_s=ratio_s,
                         nb_l=nb, tonality=tb)


@lru_cache(maxsize=None)
def get_model(sample_rate: int) -> PsyModel:
    return PsyModel(sample_rate)


def block_type_sequence(pcm: np.ndarray, sample_rate: int,
                        attack_ratio: float = 8.0,
                        floor: float = 1e-6) -> np.ndarray:
    """Per-granule block types (0 long, 1 start, 2 short, 3 stop) from
    transient detection, with legal transition sequencing."""
    x = pcm.mean(axis=1) if pcm.ndim == 2 else pcm
    G = len(x) // SPF
    if G == 0:
        return np.zeros(0, np.int64)
    # high-pass emphasizes attacks
    hp = np.diff(x, prepend=x[:1])
    # sub-block (64-sample) energies over the WHOLE signal: detection at
    # sub-block level with a trailing cross-granule context window, so an
    # attack straddling a granule boundary (tail inflating the previous
    # granule, head starting the next) is never missed — the per-granule
    # formulation reset its baseline at each boundary and lost exactly
    # those onsets.
    e = (hp[: G * SPF].reshape(G * 9, 64) ** 2).sum(axis=1)
    return block_types_from_subblock_energy(e, attack_ratio, floor)


def block_types_from_subblock_energy(e: np.ndarray,
                                     attack_ratio: float = 8.0,
                                     floor: float = 1e-6) -> np.ndarray:
    """block_type_sequence's decision half, from precomputed 64-sample
    sub-block energies e [G*9] (sum of squared high-pass samples). The
    device-resident encode path computes e ON DEVICE (device.py
    _subblock_energy_jit) and downloads only these tiny rows — the
    label semantics live here, shared with the host-PCM path."""
    G = len(e) // 9
    if G == 0:
        return np.zeros(0, np.int64)
    e = e[: G * 9].astype(np.float64) + floor
    from numpy.lib.stride_tricks import sliding_window_view
    prev = np.concatenate([np.full(9, e[0]), e[:-1]])
    ctx = sliding_window_view(prev, 9)            # [G*9, 9] trailing blocks
    base = ctx.min(axis=1)
    tmean = ctx.mean(axis=1)
    # rise vs the quietest recent sub-block catches windowed (gradual)
    # onsets; the 3x-trailing-mean condition rejects steady tones whose
    # sub-block energies merely beat against the 64-sample analysis grid
    # (beat peak/mean stays well under 3 for any sinusoidal AM).
    attack_sub = (e / base > attack_ratio) & (e > 3.0 * tmean) & (e > 1e-4)
    attack = attack_sub.reshape(G, 9).any(axis=1)
    bt = np.zeros(G, np.int64)
    bt[attack] = 2
    # a short granule needs a start before and a stop after
    for g in range(G):
        if bt[g] == 2:
            if g > 0 and bt[g - 1] == 0:
                bt[g - 1] = 1
            if g + 1 < G and bt[g + 1] == 0:
                bt[g + 1] = 3
    # fix illegal starts created by later shorts (start must precede short)
    for g in range(G - 1):
        if bt[g] == 1 and bt[g + 1] not in (2,):
            bt[g] = 0 if bt[g + 1] == 0 else bt[g]
        if bt[g] == 3 and g + 1 < G and bt[g + 1] == 2:
            bt[g] = 2  # short run continues
    return bt


@lru_cache(maxsize=None)
def _spreading_matrix(sample_rate: int) -> np.ndarray:
    """[22, 22] bark-domain spreading over long scalefactor bands
    (legacy band-energy model; the PM2 path spreads over ~1/3-bark
    partitions instead)."""
    bands = LONG[sample_rate]
    centers = (bands[:-1] + bands[1:]) / 2.0 * sample_rate / 1152.0
    bark = _bark(centers)
    d = bark[None, :] - bark[:, None]   # masker i -> maskee j distance
    sl = np.where(d >= 0, -25.0 * d, 10.0 * d)
    return 10.0 ** (sl / 10.0)


def masking_thresholds(xr: np.ndarray, sample_rate: int) -> np.ndarray:
    """Per-long-band allowed noise energy (xmin) for one granule's
    spectrum xr [576] — band energy, spread, offset by tonality.

    Legacy MDCT-domain model kept as the no-FFT fallback; the encoder's
    noise_shaping path uses PsyModel (FFT analysis) instead."""
    bands = LONG[sample_rate]
    e = np.zeros(22)
    for b in range(22):
        seg = xr[bands[b]:bands[b + 1]]
        e[b] = (seg ** 2).sum() + 1e-12
    spread = e @ _spreading_matrix(sample_rate)
    # tonality via spectral flatness of the band energies
    sfm = np.exp(np.mean(np.log(e))) / np.mean(e)
    tonality = min(sfm / 0.05, 1.0)  # 0 tonal .. 1 noisy
    offset_db = -(14.5 + 5.5) * (1 - tonality) - 5.5 * tonality
    return spread * 10.0 ** (offset_db / 10.0)
