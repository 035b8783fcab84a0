"""Device psychoacoustic model 2 (SURVEY.md E3, §3.4).

Counterpart of mp3tpu.encoder.psy_device: a batched torch port of
psymodel.PsyModel.analyze that maps [B, n] PCM onto per-granule
threshold/energy ratios for a whole batch of channels. The FFT analysis is
independent per granule; the tables come from the same PsyModel (through
EncoderTables), and the numpy model stays the reference (the device output
is float32-close, asserted by tests, and only shapes the outer loop's
allowed-distortion targets).

Short-window analysis runs for all granules (the three 256-point FFTs per
granule are small next to the long path) and non-short granules are masked
to the "unused" sentinel downstream, mirroring the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from .psymodel import (NFFT_L, NFFT_S, NMT_DB, RPELEV1, RPELEV2, SNR_S_DB,
                       SPF, TMN_DB)
from .tables import EncoderTables, encoder_tables

# granules of one analysis call (whole channel rows): bounds the frames' and
# the spectra's temporaries
PSY_GRANULES = 16384


def _shift(a: torch.Tensor, k: int, fill: float) -> torch.Tensor:
    """a delayed by k granules along dim 1, `fill` in front."""
    return torch.cat([a.new_full((a.shape[0], k) + a.shape[2:], fill),
                      a[:, :-k]], dim=1)


def _analyze(t: EncoderTables, pcm: torch.Tensor, G: int, align: int):
    """pcm f32 [B, >= G*576] -> (ratio_l [B,G,21], ratio_s [B,G,3,12]).

    align > 0 analyzes a copy of the signal delayed by that many samples
    (psymodel.MDCT_ALIGN) without materializing it: the analysis frames
    start that much earlier instead, so the staged device PCM is shared
    with the MDCT (which must see the unshifted signal). Equivalent to
    analyze(align_to_mdct(pcm)) up to the zero-fill at the start (asserted
    by tests)."""
    B = pcm.shape[0]
    # both paths pad by NFFT_L so an aligned (earlier) start stays in range:
    # the least start is -(NFFT_L - SPF) // 2 - align = -752 > -1024
    pad = pcm.new_zeros(B, NFFT_L)
    x = torch.cat([pad, pcm[:, : G * SPF], pad], dim=1)
    start_l = NFFT_L - (NFFT_L - SPF) // 2 - align
    fr = x[:, start_l:].unfold(1, NFFT_L, SPF)[:, :G] * t.win_l  # [B, G, 1024]
    spec = torch.fft.rfft(fr, dim=2)
    r = spec.abs()
    f = torch.atan2(spec.imag, spec.real)
    r1, r2 = _shift(r, 1, 0.0), _shift(r, 2, 0.0)
    f1, f2 = _shift(f, 1, 0.0), _shift(f, 2, 0.0)
    rp = 2.0 * r1 - r2
    fp = 2.0 * f1 - f2
    num = torch.sqrt((r * torch.cos(f) - rp * torch.cos(fp)) ** 2
                     + (r * torch.sin(f) - rp * torch.sin(fp)) ** 2)
    c = num / torch.clamp(r + rp.abs(), min=1e-30)
    e_bin = r * r
    eb = e_bin @ t.red_l
    cb = (c * e_bin) @ t.red_l
    ecb = eb @ t.spread_l.T
    ct = cb @ t.spread_l.T
    cbn = torch.clamp(ct / torch.clamp(ecb, min=1e-30), 0.05, 1.0)
    tb = torch.clamp(-0.299 - 0.43 * torch.log(cbn), 0.0, 1.0)
    snr_db = torch.maximum(t.minval_l, tb * TMN_DB + (1.0 - tb) * NMT_DB)
    nb = ecb * 10.0 ** (-snr_db / 10.0)
    nb1 = _shift(nb, 1, float("inf"))
    nb2 = _shift(nb, 2, float("inf"))
    nb = torch.minimum(nb, torch.minimum(RPELEV1 * nb1, RPELEV2 * nb2))
    nb = torch.maximum(nb, t.qthr_l)
    ratio_l = (nb @ t.w_l) / torch.clamp(eb @ t.w_l, min=1e-30)

    # short path for every granule (non-short ones are masked downstream);
    # shares the long path's NFFT_L-padded signal (aligned starts need it)
    start_s = NFFT_L - (NFFT_S - 192) // 2 - align
    frs = x[:, start_s:].unfold(1, NFFT_S, 192)[:, : 3 * G] * t.win_s
    es = torch.fft.rfft(frs, dim=2).abs() ** 2                   # [B, 3G, 129]
    ebs = es @ t.red_s
    ecbs = ebs @ t.spread_s.T
    nbs = (ecbs * 10.0 ** (-SNR_S_DB / 10.0)).reshape(B, G, 3, -1)
    n0 = nbs[:, :, 0]
    n1 = torch.minimum(nbs[:, :, 1], RPELEV1 * n0)
    n2 = torch.minimum(nbs[:, :, 2], RPELEV1 * n1)
    nbs = torch.maximum(torch.stack([n0, n1, n2], dim=2), t.qthr_s)
    ratio_s = (nbs @ t.w_s12) / torch.clamp(
        ebs.reshape(B, G, 3, -1) @ t.w_s12, min=1e-30)
    return ratio_l, ratio_s


def analyze_batch_handle(pcm_dev: torch.Tensor, G: int, sample_rate: int,
                         align: int = 0):
    """Staged device pcm [B, >= G*576] f32 -> device ratios (ratio_l
    [B,G,21], ratio_s [B,G,3,12]); the batch encoder combines them with band
    energies into xmin rows without a host round-trip. Non-short masking
    happens downstream, on the device."""
    t = encoder_tables(sample_rate, pcm_dev.device)
    rows = max(1, PSY_GRANULES // max(G, 1))
    parts = [_analyze(t, pcm_dev[lo: lo + rows], G, align)
             for lo in range(0, pcm_dev.shape[0], rows)]
    if len(parts) == 1:
        return parts[0]
    return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]))


def analyze_batch(pcm: np.ndarray, block_types: np.ndarray,
                  sample_rate: int, align: int = 0, device="cuda"):
    """pcm [B, G*576] (channels as rows), block_types [B, G], on the host.

    Returns (ratio_l [B,G,21] f64, ratio_s [B,G,3,12] f64) with the
    non-short granules' ratio_s at the reference's unused sentinel.
    align: see _analyze (pass psymodel.MDCT_ALIGN when pcm is the raw signal
    rather than an already-delayed copy)."""
    G = pcm.shape[1] // SPF
    x = torch.as_tensor(np.ascontiguousarray(pcm, np.float32)).to(device)
    rl, rs = analyze_batch_handle(x, G, sample_rate, align)
    rl = rl.cpu().numpy().astype(np.float64)
    rs = rs.cpu().numpy().astype(np.float64)
    rs[block_types != 2] = 1e9
    return rl, rs
