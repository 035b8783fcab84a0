"""Per-(samplerate, block-flavor) spectral index maps (SURVEY.md C1/C3).

Everything the device pipeline needs to know about scalefactor-band
geometry is precomputed here as dense gather maps:

  band_map[576]  : transmitted-order line -> exponent band slot
  reorder[576]   : natural-order line -> transmitted-order line
                   (gather with this permutation de-interleaves short
                    blocks; identity for long blocks) [ISO §2.4.3.4.8]

Band slot layout (64 slots per granule-channel):
  slot s          = long scalefactor band s        (0..21)
  slot 22+w*13+s  = short band s of window w       (22..60)

Natural (post-reorder) short layout within a subband: 18 lines =
[w0 k0..k5, w1 k0..k5, w2 k0..k5] — the IMDCT matrices in
tables/filterbank.py are built against this convention.

Frozen copy of mp3tpu_torch.tables.maps for the benchmark's plain
reference: it imports nothing of the program, and a change to the program
does not move it.
"""
from __future__ import annotations

import numpy as np

from .sfb import LONG, SHORT

N_BAND_SLOTS = 64
FLAVOR_LONG, FLAVOR_SHORT, FLAVOR_MIXED = 0, 1, 2


def _long_band_of(sr: int) -> np.ndarray:
    bands = LONG[sr]
    out = np.zeros(576, np.int32)
    for s in range(22):
        out[bands[s]:bands[s + 1]] = s
    return out


def _short_line_band(sr: int) -> np.ndarray:
    """short-line ell (0..191) -> short sfb index."""
    bands = SHORT[sr]
    out = np.zeros(192, np.int32)
    for s in range(13):
        out[bands[s]:bands[s + 1]] = s
    return out


def band_map(sr: int, flavor: int) -> np.ndarray:
    """transmitted line -> band slot (int32[576])."""
    if flavor == FLAVOR_LONG:
        return _long_band_of(sr)
    bands = SHORT[sr]
    lb = _short_line_band(sr)
    out = np.zeros(576, np.int32)
    if flavor == FLAVOR_SHORT:
        start_sfb = 0
    else:
        out[:36] = _long_band_of(sr)[:36]
        start_sfb = int(np.searchsorted(bands * 3, 36))
    for s in range(start_sfb, 13):
        lo, hi = int(bands[s]), int(bands[s + 1])
        width = hi - lo
        base = 3 * lo
        if flavor == FLAVOR_MIXED and base < 36:
            base = 36  # 8 kHz mixed gap guard
        for w in range(3):
            a = base + w * width
            out[a:a + width] = 22 + w * 13 + s
    return out


def reorder_map(sr: int, flavor: int) -> np.ndarray:
    """natural line -> transmitted line (int32[576]); gather with this to
    convert the transmitted (band-interleaved) short spectrum into
    subband-natural order."""
    out = np.arange(576, dtype=np.int32)
    if flavor == FLAVOR_LONG:
        return out
    bands = SHORT[sr]
    lb = _short_line_band(sr)
    start_line = 0 if flavor == FLAVOR_SHORT else 36
    for sb in range(32):
        for w in range(3):
            for k in range(6):
                nat = sb * 18 + w * 6 + k
                if nat < start_line:
                    continue  # mixed: long region is identity
                ell = sb * 6 + k            # short-line index
                s = int(lb[ell])
                lo, hi = int(bands[s]), int(bands[s + 1])
                trans = 3 * lo + w * (hi - lo) + (ell - lo)
                out[nat] = trans
    return out


_cache: dict = {}


def get_maps(sr: int):
    """(band_maps [3,576], reorder_maps [3,576]) stacked by flavor."""
    if sr not in _cache:
        bm = np.stack([band_map(sr, f) for f in range(3)])
        rm = np.stack([reorder_map(sr, f) for f in range(3)])
        _cache[sr] = (bm, rm)
    return _cache[sr]
