"""Graphic EQ: a 511-tap linear-phase FIR with a streaming overlap tail
(counterpart of mp3tpu.dsp.eq).

The FIR is an unfold of the input into windows of n_taps samples and one
float32 matrix product with the reversed taps, not a cuDNN convolution: a
float32 product runs in full float32 on the card (cuDNN's convolutions
default to TF32), and its order of summation does not depend on an
algorithm chosen per shape.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

DEFAULT_BANDS = (31.0, 62.0, 125.0, 250.0, 500.0, 1000.0,
                 2000.0, 4000.0, 8000.0, 16000.0)


@lru_cache(maxsize=None)
def design_fir(band_gains_db: tuple, sample_rate: int, n_taps: int = 511) -> np.ndarray:
    """Linear-phase FIR via frequency sampling of a log-interpolated
    10-band target response (float64)."""
    bands = np.asarray(DEFAULT_BANDS)
    gains = np.asarray(band_gains_db, np.float64)
    nyq = sample_rate / 2.0
    n_fft = n_taps + 1
    freqs = np.linspace(0, nyq, n_fft // 2 + 1)
    logf = np.log10(np.maximum(freqs, 1.0))
    target_db = np.interp(logf, np.log10(bands), gains,
                          left=gains[0], right=gains[-1])
    mag = 10.0 ** (target_db / 20.0)
    # linear phase: real, even impulse response
    full = np.concatenate([mag, mag[-2:0:-1]])
    h = np.real(np.fft.ifft(full))
    h = np.roll(h, n_taps // 2)[:n_taps]
    h *= np.hanning(n_taps)
    return h


def fir_valid(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """out[t, c] = sum_k x[t + k, c] * h[n_taps - 1 - k]: the FIR over
    x [n + n_taps - 1, ch] without padding -> [n, ch] float32."""
    n_taps = h.shape[0]
    win = x.T.unfold(1, n_taps, 1)                  # [ch, n, n_taps]
    return (win @ h.flip(0)).T


class GraphicEQ:
    """Streaming 10-band graphic EQ for PCM [n, ch] on `device`."""

    def __init__(self, band_gains_db, sample_rate: int, n_taps: int = 511,
                 device="cuda"):
        self.h = torch.as_tensor(
            design_fir(tuple(band_gains_db), sample_rate, n_taps),
            dtype=torch.float32, device=device)
        self.n_taps = n_taps

    def init_state(self, channels: int) -> torch.Tensor:
        return torch.zeros((self.n_taps - 1, channels), dtype=torch.float32,
                           device=self.h.device)

    def __call__(self, pcm: torch.Tensor, state=None):
        if state is None:
            state = self.init_state(pcm.shape[1])
        x = torch.cat([state, pcm], dim=0)
        return fir_valid(x, self.h), x[-(self.n_taps - 1):]
