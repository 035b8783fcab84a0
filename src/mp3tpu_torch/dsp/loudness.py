"""Track loudness + normalization gain (ReplayGain-style).

(Counterpart of mp3tpu.dsp.loudness, copied as it is: mp3tpu.dsp imports JAX on
import, which the port never does.)

Album/article queues sound wrong when tracks were mastered at
different levels; the queue normalizes them to a common target. The
statistic is the classic ReplayGain one — the 95th percentile of
overlapped 400 ms mean-square blocks — computed from the decode
pipeline's per-granule power envelope (the same [granules] array the
segmentation path reduces ON DEVICE; the PCM itself never crosses
D2H). Not BS.1770: there is no K-weighting filter bank; the target is
RELATIVE matching between tracks decoded by the same pipeline, where
the spectral weighting largely cancels.
"""
from __future__ import annotations

import numpy as np

TARGET_DB = -14.0   # streaming-typical reference loudness
BLOCK_S = 0.4       # ReplayGain block length
STRIDE_S = 0.1      # 75% overlap
GATE_DB = -70.0     # drop silent blocks from the statistic


def loudness_db(env_db: np.ndarray, hop: int, sr: int) -> float:
    """Loudness (dB of mean-square, 0 dBFS sine = -3) from a per-hop
    power envelope in dB. Returns -inf for all-silent input."""
    env_db = np.asarray(env_db, np.float32)
    if not len(env_db):
        return float("-inf")
    p = 10.0 ** (env_db / 10.0)
    bl = max(1, int(round(BLOCK_S * sr / hop)))
    stride = max(1, int(round(STRIDE_S * sr / hop)))
    if len(p) < bl:
        blocks = np.array([p.mean()])
    else:
        c = np.concatenate([[0.0], np.cumsum(p)])
        starts = np.arange(0, len(p) - bl + 1, stride)
        blocks = (c[starts + bl] - c[starts]) / bl
    db = 10.0 * np.log10(blocks + 1e-12)
    db = db[db > GATE_DB]
    if not len(db):
        return float("-inf")
    return float(np.percentile(db, 95))


def normalization_gain_db(loudness: float,
                          target_db: float = TARGET_DB,
                          max_boost_db: float = 12.0,
                          peak_db: float | None = None,
                          base_gain_db: float = 0.0) -> float:
    """Normalization OFFSET that moves a track of the given loudness to
    `target_db`. Boost is capped (a near-silent track must not be
    amplified into noise); attenuation is not. `peak_db` (the track's
    sample peak in dBFS) additionally clamps the offset so the TOTAL
    applied gain (`base_gain_db` + offset) keeps the peak at or below
    full scale — quiet-but-dynamic material must not hard-clip (the
    ReplayGain clipping-prevention rule). The clamp only shrinks the
    offset toward 0; a base gain that clips on its own is the caller's
    explicit choice, not normalization's to override."""
    if loudness == float("-inf"):
        return 0.0
    g = min(target_db - loudness, max_boost_db)
    if peak_db is not None:
        g = min(g, max(0.0, -peak_db - base_gain_db))
    return float(g)
