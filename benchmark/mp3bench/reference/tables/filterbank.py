"""Filterbank constant matrices — ISO 11172-3 §2.4.3.4.10 (hybrid IMDCT)
and §2.4.3.2.2/Annex B.3 (polyphase synthesis).

Everything is generated in float64 from spec formulas at import. The only
tabulated data is the 512-tap synthesis prototype window (Annex B.3),
committed as extracted spec data in tables/synth_window.py; its
sign/symmetry reconstruction convention was verified behaviorally against
libmpg123 impulse responses (see tests/test_oracle_mpg123.py).

Frozen copy of mp3tpu_torch.tables.filterbank for the benchmark's plain
reference: it imports nothing of the program, and a change to the program
does not move it.
"""
from __future__ import annotations

import numpy as np

from .synth_window import ENWINDOW_HALF_X65536

N_SUBBANDS = 32


# ---------------------------------------------------------------- IMDCT

def imdct_window(block_type: int) -> np.ndarray:
    """36-tap window per block type [§2.4.3.4.10.3]."""
    i = np.arange(36)
    normal = np.sin(np.pi / 36.0 * (i + 0.5))
    if block_type == 0:
        return normal
    if block_type == 1:  # start
        w = normal.copy()
        w[18:24] = 1.0
        w[24:30] = np.sin(np.pi / 12.0 * (np.arange(24, 30) - 18 + 0.5))
        w[30:] = 0.0
        return w
    if block_type == 3:  # stop
        w = normal.copy()
        w[:6] = 0.0
        w[6:12] = np.sin(np.pi / 12.0 * (np.arange(6, 12) - 6 + 0.5))
        w[12:18] = 1.0
        return w
    raise ValueError(block_type)


def imdct36_matrix() -> np.ndarray:
    """[18, 36]: out[i] = sum_k X[k] cos(pi/72 (2i+1+18)(2k+1))."""
    i = np.arange(36)[None, :]
    k = np.arange(18)[:, None]
    return np.cos(np.pi / 72.0 * (2 * i + 1 + 18) * (2 * k + 1))


def imdct12_matrix() -> np.ndarray:
    """[6, 12]: out[i] = sum_k X[k] cos(pi/24 (2i+1+6)(2k+1))."""
    i = np.arange(12)[None, :]
    k = np.arange(6)[:, None]
    return np.cos(np.pi / 24.0 * (2 * i + 1 + 6) * (2 * k + 1))


def imdct_block_matrices() -> np.ndarray:
    """[4, 18, 36] windowed IMDCT per block type; input is one subband's 18
    spectral lines in natural order (short: [w*6+k]), output 36 windowed
    time samples ready for overlap-add."""
    out = np.zeros((4, 18, 36))
    m36 = imdct36_matrix()
    for bt in (0, 1, 3):
        out[bt] = m36 * imdct_window(bt)[None, :]
    # short: three 12-point IMDCTs at offsets 6, 12, 18 within the 36 frame
    m12 = imdct12_matrix()
    wshort = np.sin(np.pi / 12.0 * (np.arange(12) + 0.5))
    for w in range(3):
        base = 6 + 6 * w
        out[2, w * 6:(w + 1) * 6, base:base + 12] += m12 * wshort[None, :]
    return out


# ----------------------------------------------------- alias reduction

_ALIAS_C = np.array([-0.6, -0.535, -0.33, -0.185, -0.095, -0.041, -0.0142, -0.0037])
ALIAS_CS = 1.0 / np.sqrt(1.0 + _ALIAS_C ** 2)
ALIAS_CA = _ALIAS_C / np.sqrt(1.0 + _ALIAS_C ** 2)


def alias_boundaries(block_type: int, mixed: bool) -> int:
    """number of subband boundaries to alias-reduce [§2.4.3.4.10.1]."""
    if block_type != 2:
        return 31
    return 1 if mixed else 0


# ------------------------------------------------------- synthesis bank

def synthesis_window() -> np.ndarray:
    """Full 512-tap D window from the 257-tap half table.

    Reconstruction: D[i] = w[i] for i < 257; D[512-i] = -w[i] unless i is a
    multiple of 64 (convention verified against libmpg123 behaviorally).
    """
    w = ENWINDOW_HALF_X65536.astype(np.float64) / 65536.0
    D = np.zeros(512)
    D[:257] = w
    for i in range(1, 256):
        D[512 - i] = -w[i] if (i % 64) else w[i]
    return D


def synthesis_matrix() -> np.ndarray:
    """N[64, 32]: V = N @ S matrixing [§2.4.3.2.2]."""
    i = np.arange(64)[:, None]
    k = np.arange(32)[None, :]
    return np.cos((16 + i) * (2 * k + 1) * np.pi / 64.0)

