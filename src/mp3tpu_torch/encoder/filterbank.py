"""Encoder filterbank: analysis polyphase + forward MDCT + forward alias
(SURVEY.md E1/E2) — ISO 11172-3 §2.4.3.2 and Annex C.

TPU-idiomatic like the decoder: the analysis FIFO is re-expressed as a
16-tap FIR over 32-sample PCM blocks (derived by impulse-probing the
scalar spec implementation), the MDCT is a windowed [36->18] constant
matrix per block type, and the forward alias butterflies are the exact
transpose of the decoder's (the butterflies are rotations).

Copy of mp3tpu.encoder.filterbank, kept in the port so that it imports nothing of
the JAX package; the code is the same.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..tables import filterbank as dfb
from ..tables.synth_window import ENWINDOW_HALF_X65536


def analysis_window() -> np.ndarray:
    """512-tap analysis window C [Annex B.3]; same extension rule as the
    synthesis window, scaled by 1/32 (verified by perfect-reconstruction
    against the mpg123-validated synthesis bank: residual ~2e-4, the
    filterbank's inherent near-PR floor)."""
    w = ENWINDOW_HALF_X65536.astype(np.float64) / 65536.0 / 32.0
    C = np.zeros(512)
    C[:257] = w
    for i in range(1, 256):
        C[512 - i] = -w[i] if (i % 64) else w[i]
    return C


def analysis_matrix() -> np.ndarray:
    """M[32, 64]: S = M @ Y [§2.4.3.2]."""
    i = np.arange(32)[:, None]
    k = np.arange(64)[None, :]
    return np.cos((2 * i + 1) * (k - 16) * np.pi / 64.0)


class AnalysisFIFO:
    """Scalar reference: 32 PCM samples in -> 32 subband samples out."""

    def __init__(self, channels: int = 1):
        self.C = analysis_window()
        self.M = analysis_matrix()
        self.X = np.zeros((channels, 512))

    def step(self, block: np.ndarray) -> np.ndarray:
        """block: [channels, 32] -> [channels, 32] subband samples."""
        X = self.X
        X[:, 32:] = X[:, :-32]
        X[:, :32] = block[:, ::-1]
        Z = X * self.C
        Y = Z.reshape(-1, 8, 64).sum(axis=1)
        return Y @ self.M.T


@lru_cache(maxsize=None)
def analysis_fir() -> np.ndarray:
    """A[16, 32, 32]: S_t = sum_d P_{t-d} @ A[d], P_t = t-th 32-sample
    PCM block. Derived by impulse probing AnalysisFIFO."""
    A = np.zeros((16, 32, 32))
    for k in range(32):
        fifo = AnalysisFIFO(1)
        blk = np.zeros((1, 32))
        blk[0, k] = 1.0
        for d in range(16):
            out = fifo.step(blk if d == 0 else np.zeros((1, 32)))
            A[d, k, :] = out[0]
    return A


@lru_cache(maxsize=None)
def mdct_matrices() -> np.ndarray:
    """[4, 36, 18] forward windowed MDCT per block type: input is 36
    subband time samples (previous granule's 18 + current 18), output 18
    spectral lines. Built as the scaled transpose of the decoder's
    windowed IMDCT — the ISO window sequence is a lapped orthogonal
    transform, so analysis = (4/2N) * synthesis^T reconstructs exactly
    through overlap-add, where 2N is the MDCT size of the block: 36 for
    long/start/stop, 12 for each of the short block's three sub-MDCTs
    (the composite [18,36] short matrix stacks three size-12 transforms,
    so its transpose needs 4/12, NOT 4/36 — verified by the legal-
    sequence perfect-reconstruction test in test_encoder.py)."""
    inv = dfb.imdct_block_matrices()     # [4, 18, 36]
    fwd = (4.0 / 36.0) * inv.transpose(0, 2, 1)
    fwd[2] *= 3.0                        # 4/12 for the short sub-MDCTs
    return fwd


@lru_cache(maxsize=None)
def forward_alias_matrices() -> np.ndarray:
    """[3, 576, 576] forward (encoder) alias per flavor = decoder RA^T
    restricted to alias only (reorder excluded; the encoder emits natural
    order then applies the inverse permutation separately)."""
    from ..oracle.decoder import alias_reduce
    out = np.zeros((3, 576, 576))
    n_bound = {0: 31, 1: 0, 2: 1}
    eye = np.eye(576)
    for f in range(3):
        A = np.stack([alias_reduce(eye[r].reshape(32, 18), n_bound[f]).ravel()
                      for r in range(576)])
        out[f] = A.T  # butterflies are rotations: inverse == transpose
    return out
