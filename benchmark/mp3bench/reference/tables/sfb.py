"""Scalefactor-band boundary tables — ISO/IEC 11172-3 Annex B, Table B.8
(MPEG-1) and ISO/IEC 13818-3 (MPEG-2/2.5 LSF extension).

Data recovered from the system libmpg123's bandInfo structure (pure spec
data; see tools/extract_spec_tables.py) and cross-validated by the
longDiff/shortDiff internal-consistency checks and by decode parity tests
against libmpg123 on real streams.

`LONG[sr]` has 23 entries (22 long scalefactor bands, the last band —
sfb 21 — has no transmitted scalefactor). `SHORT[sr]` has 14 entries
(13 short bands per window, each window 192 lines).

Frozen copy of mp3tpu_torch.tables.sfb for the benchmark's plain
reference: it imports nothing of the program, and a change to the program
does not move it.
"""
from __future__ import annotations

import numpy as np

LONG: dict[int, np.ndarray] = {
    44100: np.array([0, 4, 8, 12, 16, 20, 24, 30, 36, 44, 52, 62, 74, 90, 110,
                     134, 162, 196, 238, 288, 342, 418, 576], np.int32),
    48000: np.array([0, 4, 8, 12, 16, 20, 24, 30, 36, 42, 50, 60, 72, 88, 106,
                     128, 156, 190, 230, 276, 330, 384, 576], np.int32),
    32000: np.array([0, 4, 8, 12, 16, 20, 24, 30, 36, 44, 54, 66, 82, 102, 126,
                     156, 194, 240, 296, 364, 448, 550, 576], np.int32),
    22050: np.array([0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 116, 140,
                     168, 200, 238, 284, 336, 396, 464, 522, 576], np.int32),
    24000: np.array([0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 114, 136,
                     162, 194, 232, 278, 332, 394, 464, 540, 576], np.int32),
    16000: np.array([0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 116, 140,
                     168, 200, 238, 284, 336, 396, 464, 522, 576], np.int32),
    11025: np.array([0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 116, 140,
                     168, 200, 238, 284, 336, 396, 464, 522, 576], np.int32),
    12000: np.array([0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 116, 140,
                     168, 200, 238, 284, 336, 396, 464, 522, 576], np.int32),
    8000: np.array([0, 12, 24, 36, 48, 60, 72, 88, 108, 132, 160, 192, 232,
                    280, 336, 400, 476, 566, 568, 570, 572, 574, 576], np.int32),
}

SHORT: dict[int, np.ndarray] = {
    44100: np.array([0, 4, 8, 12, 16, 22, 30, 40, 52, 66, 84, 106, 136, 192], np.int32),
    48000: np.array([0, 4, 8, 12, 16, 22, 28, 38, 50, 64, 80, 100, 126, 192], np.int32),
    32000: np.array([0, 4, 8, 12, 16, 22, 30, 42, 58, 78, 104, 138, 180, 192], np.int32),
    22050: np.array([0, 4, 8, 12, 18, 24, 32, 42, 56, 74, 100, 132, 174, 192], np.int32),
    24000: np.array([0, 4, 8, 12, 18, 26, 36, 48, 62, 80, 104, 136, 180, 192], np.int32),
    16000: np.array([0, 4, 8, 12, 18, 26, 36, 48, 62, 80, 104, 134, 174, 192], np.int32),
    11025: np.array([0, 4, 8, 12, 18, 26, 36, 48, 62, 80, 104, 134, 174, 192], np.int32),
    12000: np.array([0, 4, 8, 12, 18, 26, 36, 48, 62, 80, 104, 134, 174, 192], np.int32),
    8000: np.array([0, 8, 16, 24, 36, 52, 72, 96, 124, 160, 162, 164, 166, 192], np.int32),
}

# Preemphasis table, one entry per long scalefactor band [ISO 11172-3
# §2.4.3.4.7.1]; applied when preflag is set.
PRETAB = np.array([0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 3, 2, 0],
                  np.int32)

# scalefac_compress -> (slen1, slen2) [ISO 11172-3 §2.4.2.7]
SLEN1 = np.array([0, 0, 0, 0, 3, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4], np.int32)
SLEN2 = np.array([0, 1, 2, 3, 0, 1, 2, 3, 1, 2, 3, 1, 2, 3, 2, 3], np.int32)

MPEG1_RATES = (44100, 48000, 32000)
MPEG2_RATES = (22050, 24000, 16000)
MPEG25_RATES = (11025, 12000, 8000)
