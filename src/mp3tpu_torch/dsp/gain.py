"""Volume / gain with zipper-free ramping (counterpart of mp3tpu.dsp.gain)."""
from __future__ import annotations

import numpy as np
import torch


def gain_ramp(gain0: float, gain1: float, n: int, ramp_samples: int,
              device) -> torch.Tensor:
    """float32 [n] amplitude: linear from gain0 to gain1 over the first
    min(ramp_samples, n) samples, then gain1. With gain0 == gain1 it is
    exactly constant."""
    r = min(ramp_samples, n)
    g0, g1 = float(np.float32(gain0)), float(np.float32(gain1))
    return torch.cat([
        torch.linspace(g0, g1, r, dtype=torch.float32, device=device),
        torch.full((n - r,), g1, dtype=torch.float32, device=device)])


def apply_gain(pcm: torch.Tensor, gain_db: float,
               prev_gain_db: float | None = None, ramp_samples: int = 256):
    """Scale PCM [n, ch] by gain_db; if prev_gain_db differs, ramp
    linearly (in amplitude) over ramp_samples to avoid zipper noise."""
    g1 = 10.0 ** (gain_db / 20.0)
    if prev_gain_db is None or prev_gain_db == gain_db:
        return pcm * float(np.float32(g1))
    g0 = 10.0 ** (prev_gain_db / 20.0)
    return pcm * gain_ramp(g0, g1, pcm.shape[0], ramp_samples,
                           pcm.device)[:, None]
