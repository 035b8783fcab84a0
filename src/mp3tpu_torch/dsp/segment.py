"""Silence-based segmentation — the navigation half of the reference's
repeat-listening pattern.

(Counterpart of mp3tpu.dsp.segment, copied as it is apart from one note on
the TPU's dispatch latency: mp3tpu.dsp imports JAX on import, which the
port never does.)

The reference's core usage is "play one article or a few sentences at a
time, replay each sentence repeatedly" (reference README.md:46,
SURVEY.md §0.1). loop()/seek()/set_speed() cover the *replay* half;
this module finds the sentences: energy-envelope analysis splits a
track at pauses, giving the Player segment boundaries to loop over.

Division of labor: the heavy work (decoding PCM) is the device
pipeline; the envelope itself is a trivial O(n) mean-of-squares over
20 ms hops producing ~50 values/s, so it runs on host beside the PCM
the Player already downloaded per window — a device dispatch per
window would cost more than the entire reduction. The boundary walk is O(frames) on ~tens of
values per second of audio.
"""
from __future__ import annotations

import numpy as np

HOP_S = 0.02          # envelope hop (20 ms ~ half a short phoneme)
MIN_SILENCE_S = 0.25  # a pause shorter than this stays inside a sentence
MIN_SEGMENT_S = 0.30  # drop blips shorter than this
PAD_S = 0.06          # widen each segment into the surrounding silence
FLOOR_DB = -65.0      # below this the track is considered all-silent


def energy_envelope(pcm: np.ndarray, sr: int, hop_s: float = HOP_S):
    """Mean-square power envelope in dB at `hop_s` hops. Channels are
    squared BEFORE averaging (power sum) — an amplitude downmix would
    read out-of-phase stereo (side-heavy or inverted material) as
    silence and split mid-sentence.

    Returns (env_db [F] float32, hop_samples). Trailing samples that
    do not fill a frame are dropped (callers carrying a stream keep
    them as residue)."""
    x = np.asarray(pcm, np.float32)
    hop = max(1, int(round(sr * hop_s)))
    return env_db_from_power(sample_power(x), hop), hop


def sample_power(pcm: np.ndarray) -> np.ndarray:
    """Per-sample channel-mean power [n] of a [n] or [n, ch] buffer."""
    x = np.asarray(pcm, np.float32)
    return (x ** 2).mean(axis=1) if x.ndim == 2 else x ** 2


def env_db_from_power(p: np.ndarray, hop: int) -> np.ndarray:
    """dB envelope of a per-sample power stream (whole frames only —
    streaming callers keep the tail of p as residue)."""
    F = len(p) // hop
    if F == 0:
        return np.zeros(0, np.float32)
    e = np.mean(p[: F * hop].reshape(F, hop), axis=1)
    return (10.0 * np.log10(e + 1e-12)).astype(np.float32)


def segments_from_envelope(env_db: np.ndarray, hop: int, sr: int,
                           total: int | None = None,
                           min_silence: float = MIN_SILENCE_S,
                           min_segment: float = MIN_SEGMENT_S,
                           pad: float = PAD_S,
                           threshold_db: float | None = None):
    """Split an envelope into active segments.

    Returns a list of (start_sample, end_sample) pairs, padded `pad`
    seconds into the surrounding silence but never past the midpoint
    of the gap between two segments (so segments stay disjoint).
    `threshold_db=None` picks an adaptive threshold between the noise
    floor (10th percentile) and the active level (90th percentile)."""
    env_db = np.asarray(env_db, np.float32)
    n_total = int(total) if total is not None else len(env_db) * hop
    if not len(env_db) or n_total <= 0:
        return []
    if threshold_db is None:
        # active level from the NON-SILENT frames only: a track that is
        # >90% silence (one short sentence in a long recording) would
        # put the unconditional 90th percentile below the floor and
        # return nothing despite clear speech (ADVICE r3)
        voiced = env_db[env_db > FLOOR_DB]
        if not len(voiced):
            return []                      # all silence
        hi = float(np.percentile(voiced, 90))
        # a pause is a frame >= 25 dB under the active level — an
        # ABSOLUTE drop, not a percentile of the distribution: on
        # continuous material (music) the quiet frames are still music
        # (house_lo probe: 10th pct -21.6 dB vs active -9.4 dB, true
        # silence only at the edges near -80 dB), so percentile floors
        # put the threshold inside the program. With no frame below
        # hi-25 everything is active and the walk returns one segment
        # spanning the track — the honest answer for pause-free audio.
        threshold_db = hi - 25.0
    active = env_db >= threshold_db
    if not active.any():
        return []
    # runs of active frames
    edges = np.flatnonzero(np.diff(active.astype(np.int8)))
    starts = list((edges + 1)[~active[edges]]) if len(edges) else []
    ends = list((edges + 1)[active[edges]]) if len(edges) else []
    if active[0]:
        starts.insert(0, 0)
    if active[-1]:
        ends.append(len(active))
    # merge runs separated by less than min_silence
    min_gap_f = max(1, int(round(min_silence * sr / hop)))
    merged = [[starts[0], ends[0]]]
    for s, e in zip(starts[1:], ends[1:]):
        if s - merged[-1][1] < min_gap_f:
            merged[-1][1] = e
        else:
            merged.append([s, e])
    # drop too-short segments, convert to samples
    min_len_f = int(round(min_segment * sr / hop))
    segs = [(s * hop, e * hop) for s, e in merged if e - s >= min_len_f]
    if not segs:
        return []
    # pad into the silence, clamped at gap midpoints and track bounds
    pad_n = int(round(pad * sr))
    out = []
    for i, (s, e) in enumerate(segs):
        lo_lim = 0 if i == 0 else (segs[i - 1][1] + s) // 2
        hi_lim = n_total if i == len(segs) - 1 else (e + segs[i + 1][0]) // 2
        out.append((max(lo_lim, s - pad_n), min(hi_lim, e + pad_n)))
    return out


def split_silence(pcm: np.ndarray, sr: int, **kw):
    """One-shot: (start_sample, end_sample) segments of a PCM buffer."""
    env, hop = energy_envelope(pcm, sr, kw.pop("hop_s", HOP_S))
    return segments_from_envelope(env, hop, sr, total=len(pcm), **kw)
