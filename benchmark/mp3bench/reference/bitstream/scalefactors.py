"""Scalefactor decoding (SURVEY.md B3).

MPEG-1: ISO 11172-3 §2.4.2.7 (slen1/slen2, scfsi sharing).
LSF (MPEG-2/2.5): ISO 13818-3 §2.4.3.2 (4-partition slen/nr_of_sfb,
intensity-channel variants). Validated behaviorally against libmpg123.

Output layout (one granule-channel):
  long_sf:  int32[22]  — long-block scalefactors (sfb 21 always 0)
  short_sf: int32[13,3] — short-block scalefactors per (sfb, window)
  preflag:  effective preflag (LSF derives it from scalefac_compress)
  max_sf:   per-partition "illegal" marker values (LSF intensity),
            as int32[22] / int32[13,3] aligned with the scalefactors
  intensity_scale: LSF intensity io selector (0/1)

Frozen copy of mp3tpu_torch.bitstream.scalefactors for the benchmark's plain
reference: it imports nothing of the program, and a change to the program
does not move it.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..tables.sfb import SLEN1, SLEN2
from .sideinfo import GranuleSI


@dataclass
class Scalefactors:
    long_sf: np.ndarray = field(default_factory=lambda: np.zeros(22, np.int32))
    short_sf: np.ndarray = field(default_factory=lambda: np.zeros((13, 3), np.int32))
    preflag: int = 0
    intensity_scale: int = 0
    # LSF intensity: per-position max ("illegal") value, used to detect
    # the no-intensity marker. 0 means "MPEG-1 semantics" (illegal == 7).
    long_max: np.ndarray = field(default_factory=lambda: np.zeros(22, np.int32))
    short_max: np.ndarray = field(default_factory=lambda: np.zeros((13, 3), np.int32))
    part2_bits: int = 0


def read_scalefactors_mpeg1(r, g: GranuleSI, scfsi: list, prev: Scalefactors | None,
                            granule_index: int) -> Scalefactors:
    sf = Scalefactors()
    sf.preflag = g.preflag
    slen1 = int(SLEN1[g.scalefac_compress])
    slen2 = int(SLEN2[g.scalefac_compress])
    start = r.pos
    short = g.block_type == 2
    if short and not g.mixed_block_flag:
        for sfb in range(6):
            for w in range(3):
                sf.short_sf[sfb, w] = r.read(slen1)
        for sfb in range(6, 12):
            for w in range(3):
                sf.short_sf[sfb, w] = r.read(slen2)
    elif short:  # mixed: 8 long sfb then short sfb 3..11
        for sfb in range(8):
            sf.long_sf[sfb] = r.read(slen1)
        for sfb in range(3, 6):
            for w in range(3):
                sf.short_sf[sfb, w] = r.read(slen1)
        for sfb in range(6, 12):
            for w in range(3):
                sf.short_sf[sfb, w] = r.read(slen2)
    else:
        groups = [(0, 6, slen1), (6, 11, slen1), (11, 16, slen2), (16, 21, slen2)]
        for gi, (lo, hi, slen) in enumerate(groups):
            if granule_index == 1 and scfsi[gi]:
                assert prev is not None
                sf.long_sf[lo:hi] = prev.long_sf[lo:hi]
            else:
                for sfb in range(lo, hi):
                    sf.long_sf[sfb] = r.read(slen)
    sf.part2_bits = r.pos - start
    return sf


# LSF nr_of_sfb partition tables [ISO 13818-3 §2.4.3.2], indexed by
# [blocktypenumber][partition]; blocktypenumber: 0=long, 1=short, 2=mixed
_NSFB_NORMAL = (
    ((6, 5, 5, 5), (9, 9, 9, 9), (6, 9, 9, 9)),      # scalefac_compress < 400
    ((6, 5, 7, 3), (9, 9, 12, 6), (6, 9, 12, 6)),    # < 500
    ((11, 10, 0, 0), (18, 18, 0, 0), (15, 18, 0, 0)),  # < 512
)
_NSFB_INTENSITY = (
    ((7, 7, 7, 0), (12, 12, 12, 0), (6, 15, 12, 0)),   # int_sfc < 180
    ((6, 6, 6, 3), (12, 9, 9, 6), (6, 12, 9, 6)),      # < 244
    ((8, 8, 5, 0), (15, 12, 9, 0), (6, 18, 9, 0)),     # < 255*?
)


def lsf_partitions(g: GranuleSI, is_intensity_channel: bool):
    """Return (slen[4], nsfb[4], preflag, intensity_scale)."""
    sfc = g.scalefac_compress
    btn = 0
    if g.window_switching and g.block_type == 2:
        btn = 2 if g.mixed_block_flag else 1
    preflag = 0
    intensity_scale = 0
    if is_intensity_channel:
        intensity_scale = sfc & 1
        sfc >>= 1
        if sfc < 180:
            slen = (sfc // 36, (sfc % 36) // 6, sfc % 6, 0)
            nsfb = _NSFB_INTENSITY[0][btn]
        elif sfc < 244:
            sfc -= 180
            slen = ((sfc % 64) >> 4, (sfc % 16) >> 2, sfc % 4, 0)
            nsfb = _NSFB_INTENSITY[1][btn]
        else:
            sfc -= 244
            slen = (sfc // 3, sfc % 3, 0, 0)
            nsfb = _NSFB_INTENSITY[2][btn]
    else:
        if sfc < 400:
            slen = ((sfc >> 4) // 5, (sfc >> 4) % 5, (sfc & 15) >> 2, sfc & 3)
            nsfb = _NSFB_NORMAL[0][btn]
        elif sfc < 500:
            sfc -= 400
            slen = ((sfc >> 2) // 5, (sfc >> 2) % 5, sfc & 3, 0)
            nsfb = _NSFB_NORMAL[1][btn]
        else:
            sfc -= 500
            slen = (sfc // 3, sfc % 3, 0, 0)
            nsfb = _NSFB_NORMAL[2][btn]
            preflag = 1
    return slen, nsfb, preflag, intensity_scale


def read_scalefactors_lsf(r, g: GranuleSI, is_intensity_channel: bool) -> Scalefactors:
    sf = Scalefactors()
    slen, nsfb, sf.preflag, sf.intensity_scale = lsf_partitions(g, is_intensity_channel)
    start = r.pos
    short = g.window_switching and g.block_type == 2
    mixed = short and g.mixed_block_flag
    # flatten the transmitted scalefactor sequence, then route into
    # long/short arrays in transmission order
    seq = []
    for part in range(4):
        for _ in range(nsfb[part]):
            v = r.read(slen[part]) if slen[part] else 0
            mx = (1 << slen[part]) - 1
            seq.append((v, mx))
    i = 0
    if short and not mixed:
        for sfb in range(12):
            for w in range(3):
                if i < len(seq):
                    sf.short_sf[sfb, w], sf.short_max[sfb, w] = seq[i]
                    i += 1
    elif mixed:
        for sfb in range(6):
            if i < len(seq):
                sf.long_sf[sfb], sf.long_max[sfb] = seq[i]
                i += 1
        for sfb in range(3, 12):
            for w in range(3):
                if i < len(seq):
                    sf.short_sf[sfb, w], sf.short_max[sfb, w] = seq[i]
                    i += 1
    else:
        for sfb in range(21):
            if i < len(seq):
                sf.long_sf[sfb], sf.long_max[sfb] = seq[i]
                i += 1
    sf.part2_bits = r.pos - start
    return sf
