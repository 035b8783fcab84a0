"""Static stereo-mixing palette (SURVEY.md C2).

Every per-band 2x2 stereo mixing matrix a Layer III granule can require
comes from a small closed set: identity (L/R), mid/side, the 7 MPEG-1
intensity ratios, and the LSF intensity powers (is_pos 0..31 x 2 io
scales) — each optionally scaled by 1/sqrt(2) when MS is active. The
host therefore transmits one uint8 palette index per band (64 B per
granule-pair) instead of four f32s per band (1 KB), and the device
expands indices against this constant table with a one-hot matmul.

Index layout (shared contract between the C++/Python unpackers, the
float64 oracle, and the device pipeline):
  0                LR identity
  1                MS (1/sqrt2 butterfly)
  2 + p            MPEG-1 intensity, is_pos p in 0..6
  9 + p            (reserved; historically an MS-scaled variant — probing
                    libmpg123 showed intensity bands are NEVER 1/sqrt2
                    scaled, so these equal rows 2+p)
  16 + s*32 + p    LSF intensity, io scale s in {0,1}, is_pos p in 0..31
  80 + s*32 + p    (reserved; equals 16+s*32+p, see above)
Total P = 144 entries.

Frozen copy of mp3tpu_torch.tables.stereo_palette for the benchmark's plain
reference: it imports nothing of the program, and a change to the program
does not move it.
"""
from __future__ import annotations

import numpy as np

P = 144

IDX_LR = 0
IDX_MS = 1


def idx_mpeg1(pos: int, ms: bool) -> int:
    return (9 if ms else 2) + pos


def idx_lsf(pos: int, scale: int, ms: bool) -> int:
    return (80 if ms else 16) + scale * 32 + pos


def _intensity_mpeg1(pos: int) -> tuple[float, float]:
    if pos == 6:
        return 1.0, 0.0
    r = np.tan(pos * np.pi / 12.0)
    return float(r / (1.0 + r)), float(1.0 / (1.0 + r))


def _intensity_lsf(pos: int, scale: int) -> tuple[float, float]:
    io = 2.0 ** (-0.25 * (scale + 1))
    if pos == 0:
        return 1.0, 1.0
    p = (pos + 1) // 2
    if pos & 1:
        return float(io ** p), 1.0
    return 1.0, float(io ** p)


def build_palette() -> np.ndarray:
    """float64 [P, 2, 2]; row i is the mixing matrix for palette index i."""
    s2 = 1.0 / np.sqrt(2.0)
    pal = np.zeros((P, 2, 2))
    pal[IDX_LR] = np.eye(2)
    pal[IDX_MS] = np.array([[s2, s2], [s2, -s2]])
    for pos in range(7):
        kl, kr = _intensity_mpeg1(pos)
        pal[idx_mpeg1(pos, False)] = [[kl, 0.0], [kr, 0.0]]
        pal[idx_mpeg1(pos, True)] = [[kl, 0.0], [kr, 0.0]]
    for scale in (0, 1):
        for pos in range(32):
            kl, kr = _intensity_lsf(pos, scale)
            pal[idx_lsf(pos, scale, False)] = [[kl, 0.0], [kr, 0.0]]
            pal[idx_lsf(pos, scale, True)] = [[kl, 0.0], [kr, 0.0]]
    return pal


PALETTE = build_palette()
