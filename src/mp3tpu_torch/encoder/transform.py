"""Encoder time->frequency transform (E1+E2): PCM -> per-granule
spectra in transmitted order, the exact inverse of the decoder chain
(validated by round-trip tests through the mpg123-validated oracle).

Copy of mp3tpu.encoder.transform, kept in the port so that it imports nothing of
the JAX package; the code is the same.
"""
from __future__ import annotations

import numpy as np

from ..tables import maps as tmaps
from . import filterbank as efb

SPF = 576  # samples per granule


def subband_analysis(pcm: np.ndarray) -> np.ndarray:
    """PCM [n] (n multiple of 32) -> subband samples [n/32, 32] via the
    FIR form of the analysis polyphase bank."""
    A = efb.analysis_fir()           # [16, 32, 32]
    P = pcm.reshape(-1, 32)
    T = len(P)
    Ppad = np.concatenate([np.zeros((15, 32)), P], axis=0)
    # S[t] = sum_d P[t-d] @ A[d]
    S = np.zeros((T, 32))
    for d in range(16):
        S += Ppad[15 - d: 15 - d + T] @ A[d]
    return S


def granule_spectra(pcm: np.ndarray, block_types: np.ndarray,
                    sample_rate: int) -> np.ndarray:
    """PCM [n] -> xr [G, 576] transmitted-order spectra.

    block_types: int [G] (0 long, 1 start, 2 short, 3 stop); granule g
    consumes subband steps [g*18, (g+1)*18) plus the previous granule's
    18 (MDCT 50% overlap). Mixed blocks are not emitted by this encoder.
    """
    n = len(pcm)
    G = n // SPF
    S = subband_analysis(pcm[: G * SPF])          # [G*18, 32]
    # encoder-side frequency inversion (self-inverse mask)
    inv = np.ones((32, 18))
    inv[1::2, 1::2] = -1.0
    Sg = S.reshape(G, 18, 32).transpose(0, 2, 1) * inv[None]  # [G, 32, 18]
    Sg_prev = np.concatenate([np.zeros((1, 32, 18)), Sg[:-1]], axis=0)
    wide = np.concatenate([Sg_prev, Sg], axis=2)  # [G, 32, 36]

    fmats = efb.mdct_matrices()                   # [4, 36, 18]
    X = np.zeros((G, 32, 18))
    for bt in range(4):
        sel = block_types == bt
        if sel.any():
            X[sel] = np.einsum("gsj,jk->gsk", wide[sel], fmats[bt])
    nat = X.reshape(G, 576)

    # forward alias + inverse reorder, per flavor
    alias_f = efb.forward_alias_matrices()        # [3, 576, 576]
    _bm, rm = tmaps.get_maps(sample_rate)
    out = np.zeros((G, 576))
    for bt in range(4):
        sel = block_types == bt
        if not sel.any():
            continue
        flavor = 1 if bt == 2 else 0
        y = nat[sel] @ alias_f[flavor]
        perm = rm[flavor]                         # natural idx -> transmitted idx
        t = np.empty_like(y)
        t[:, perm] = y
        out[sel] = t
    return out
