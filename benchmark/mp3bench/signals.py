"""Seeded stereo test signals of different character, int16-origin.

One generator per kind, each a few vectorised numpy calls: the corpus
(corpus/make_corpus.py) is made from them once, and the encode traffic
draws its PCM from them at set-up. Every signal is float64 [n, 2] in
[-1, 1) holding values k / 32768, as a WAV file would.
"""
from __future__ import annotations

import numpy as np

KINDS = ("sweep", "chord", "transients", "noise", "speech", "piano", "synth",
         "mix")


def q16(a: np.ndarray) -> np.ndarray:
    """float PCM rounded to int16-origin values k / 32768."""
    return np.clip(np.rint(a * 32768.0), -32768, 32767) / 32768.0


def _shaped_noise(rng, n: int, sr: int, slope_db: float, lo: float = 20.0,
                  hi: float = 18000.0) -> np.ndarray:
    """[n, 2] noise with a spectral slope of slope_db per octave between lo
    and hi Hz, the two channels partly correlated."""
    f = np.fft.rfftfreq(n, 1.0 / sr)
    gain = np.where((f >= lo) & (f <= hi),
                    (np.maximum(f, lo) / 1000.0) ** (slope_db / 6.02), 0.0)
    spec = (rng.standard_normal((2, len(f))) + 1j * rng.standard_normal((2, len(f))))
    spec[1] = 0.7 * spec[0] + 0.3 * spec[1]
    x = np.fft.irfft(spec * gain, n).T
    return x / (np.abs(x).max() + 1e-12)


def _tones(t: np.ndarray, freqs, amps, vib_hz: float, vib: float) -> np.ndarray:
    ph = 2 * np.pi * np.outer(t, freqs) + vib * np.sin(2 * np.pi * vib_hz * t)[:, None]
    return np.sin(ph) @ np.asarray(amps)


def _envelope_hits(rng, n: int, sr: int, rate_hz: float, decay_s: float,
                   ) -> np.ndarray:
    """Sum of exponentially decaying envelopes at random onsets."""
    k = max(1, int(rate_hz * n / sr))
    on = np.zeros(n)
    on[rng.integers(0, n, k)] = rng.uniform(0.3, 1.0, k)
    kern = np.exp(-np.arange(int(decay_s * 8 * sr)) / (decay_s * sr))
    m = len(on) + len(kern) - 1
    size = 1 << (m - 1).bit_length()
    env = np.fft.irfft(np.fft.rfft(on, size) * np.fft.rfft(kern, size), size)[:n]
    return env


def make(kind: str, seconds: float, seed: int, sr: int = 44100) -> np.ndarray:
    """A signal of `kind` (KINDS), `seconds` long, from `seed`."""
    rng = np.random.default_rng([KINDS.index(kind), seed])
    n = int(round(seconds * sr))
    t = np.arange(n) / sr
    if kind == "sweep":
        f0, f1 = rng.uniform(30, 80), rng.uniform(12000, 17000)
        k = np.log(f1 / f0)
        ph = 2 * np.pi * f0 * (np.exp(t / t[-1] * k) - 1) * t[-1] / k
        m = 0.6 * np.sin(ph) + 0.25 * np.sin(2.1 * ph)
        x = np.stack([m, 0.8 * m + 0.1 * np.sin(3.3 * ph)], 1)
        x += 0.02 * _shaped_noise(rng, n, sr, 0.0)
    elif kind == "chord":
        root = rng.uniform(110, 330)
        ratios = np.array([1.0, 1.25, 1.5, 2.0, 3.0])
        amps = rng.uniform(0.2, 1.0, 5) / np.arange(1, 6)
        l = _tones(t, root * ratios, amps, rng.uniform(4, 6), 0.002 * root)
        r = _tones(t, root * ratios * 1.003, amps[::-1], rng.uniform(4, 6),
                   0.002 * root)
        x = np.stack([l, r], 1)
    elif kind == "transients":
        env = _envelope_hits(rng, n, sr, rng.uniform(3, 8), 0.03)
        thump = np.sin(2 * np.pi * rng.uniform(45, 70) * t)
        x = _shaped_noise(rng, n, sr, -1.0) * env[:, None] \
            + 0.8 * (thump * _envelope_hits(rng, n, sr, 2, 0.12))[:, None]
    elif kind == "noise":
        x = _shaped_noise(rng, n, sr, rng.uniform(-4.5, -1.5))
        x *= (0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(0.1, 0.5) * t))[:, None]
    elif kind == "speech":
        f0 = rng.uniform(90, 220) * (1 + 0.15 * np.sin(2 * np.pi * 0.7 * t))
        ph = 2 * np.pi * np.cumsum(f0) / sr
        voiced = sum(np.sin(h * ph) / h for h in range(1, 24))
        syl = np.clip(np.sin(2 * np.pi * rng.uniform(3, 5) * t), 0, None) ** 2
        m = voiced * syl + 0.3 * _shaped_noise(rng, n, sr, -2.0, 300, 8000)[:, 0] * (1 - syl)
        x = np.stack([m, m], 1)
    elif kind == "piano":
        notes = 110.0 * 2 ** (rng.integers(0, 36, 24) / 12.0)
        on = np.sort(rng.uniform(0, seconds - 0.5, 24))
        x = np.zeros((n, 2))
        for f, o in zip(notes, on):
            i0 = int(o * sr)
            tt = t[: n - i0]
            env = np.exp(-tt / rng.uniform(0.4, 1.5))
            tone = sum(np.sin(2 * np.pi * f * h * tt) / h ** 1.5 for h in range(1, 7))
            pan = rng.uniform(0.2, 0.8)
            x[i0:, 0] += (1 - pan) * env * tone
            x[i0:, 1] += pan * env * tone
    elif kind == "synth":
        f = rng.uniform(40, 90)
        saw = 2 * ((f * t) % 1.0) - 1
        lead = np.sign(np.sin(2 * np.pi * rng.uniform(300, 600) * t))
        gate = (np.sin(2 * np.pi * rng.uniform(1, 3) * t) > 0)
        x = np.stack([0.6 * saw + 0.25 * lead * gate,
                      0.6 * saw - 0.25 * lead * gate], 1)
    elif kind == "mix":
        parts = [make(k, seconds, seed, sr) for k in ("chord", "transients",
                                                      "noise")]
        x = 0.5 * parts[0] + 0.35 * parts[1] + 0.15 * parts[2]
    else:
        raise ValueError(f"unknown signal kind {kind!r}")
    # a recording's floor (room, reverb, noise) 30-36 dB under the peak:
    # no real clip has the empty spectrum of a pure tone
    x = x / (np.abs(x).max() + 1e-12)
    x += 10 ** (-rng.uniform(30, 36) / 20) * _shaped_noise(rng, n, sr, -3.0)
    x = x / (np.abs(x).max() + 1e-12) * rng.uniform(0.5, 0.85)
    return q16(x)
