"""Pitch-preserving time-stretch (phase vocoder) — the player's "slow
listening" control (counterpart of mp3tpu.dsp.timestretch).

The same vocoder as the JAX package: Laroche/Dolson with 4x-overlap
periodic Hann windows (WOLA constant 1.5) and identity phase locking, over
chunks of F_CHUNK frames. The analysis hop `ha` sets the speed
(speed = ha / HOP_SYN).

In PyTorch:
- each chunk is one call of _chunk on the device: torch.fft.rfft/irfft
  over its F_CHUNK frames, and a loop over the frames for the
  phase-locked synthesis phase (peaks move between frames);
- a drain runs one _chunk per full chunk the buffer holds (the JAX package
  runs up to C_SCAN of them as one masked lax.scan, to reuse one compiled
  program); every chunk runs the same call at the same shapes, so the
  output is the same for any way the input is fed in (chunking
  invariance) and for any number of chunks per drain;
- the streaming state is explicit and small: previous analysis phase,
  accumulated synthesis phase, overlap-add tail (tensors on the device)
  and the host input residue. state_blob()/restore_blob() use the JAX
  package's keys and layouts, so each package resumes the other's blob.

Against the JAX package the output is not bit-exact: the FFTs round
differently, and peak picking compares magnitudes that can tie.
"""
from __future__ import annotations

import math

import numpy as np
import torch

N_FFT = 2048          # analysis/synthesis window (46 ms @ 44.1 kHz)
HOP_SYN = N_FFT // 4  # synthesis hop (4x overlap -> WOLA constant 1.5)
F_CHUNK = 8           # frames per chunk
SPEED_MIN = 0.25
SPEED_MAX = 4.0
_TWO_PI = float(np.float32(2.0 * math.pi))


def _hann(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def _wrap(x: torch.Tensor) -> torch.Tensor:
    # torch.round rounds half to even, as jnp.round does
    return x - _TWO_PI * torch.round(x / _TWO_PI)


def _chunk(buf, ha: int, prev_phase, acc_phase, tail, primed: bool):
    """Stretch F_CHUNK frames of buf [(F_CHUNK-1)*ha + N_FFT, ch] into
    F_CHUNK*HOP_SYN output samples. Returns (emit, new_prev, new_acc,
    new_tail)."""
    F, N, HS = F_CHUNK, N_FFT, HOP_SYN
    dev = buf.device
    win = torch.as_tensor(_hann(N), dtype=torch.float32, device=dev)
    b = torch.arange(N // 2 + 1, dtype=torch.int32, device=dev)
    # omega_b * HS mod 2pi, exact: b*HS % N is integer arithmetic
    hs_mod = (2.0 * math.pi / N) * (b * HS % N).float()

    frames = buf.unfold(0, N, ha)[:F].transpose(1, 2)   # [F, N, ch]
    spec = torch.fft.rfft(frames * win[None, :, None], dim=1)
    mag = spec.abs()                                     # [F, B, ch]
    phase = torch.atan2(spec.imag, spec.real)

    # expected analysis-phase advance omega_b*ha mod 2pi, exact in int32
    expected = (2.0 * math.pi / N) * ((b * ha) % N).float()
    prev = torch.cat([prev_phase[None], phase[:-1]], dim=0)
    dphi = _wrap(phase - prev - expected[None, :, None])
    ratio = float(np.float32(HS) / np.float32(ha))
    inc = _wrap(hs_mod[None, :, None] + dphi * ratio)    # [F, B, ch]

    # identity phase locking (Laroche/Dolson): only spectral PEAKS
    # propagate phase; every other bin keeps its ANALYSIS phase offset to
    # its nearest peak
    B = N // 2 + 1
    idxs = torch.arange(B, device=dev)[None, :, None]
    lower = torch.full((F, 1, mag.shape[-1]), -1.0, device=dev)

    def sh(k):  # mag shifted k bins (out-of-range reads as -1)
        if k > 0:
            return torch.cat([lower.expand(-1, k, -1), mag[:, :-k]], dim=1)
        return torch.cat([mag[:, -k:], lower.expand(-1, -k, -1)], dim=1)

    is_peak = ((mag >= sh(1)) & (mag > sh(-1))
               & (mag >= sh(2)) & (mag > sh(-2)))
    left = torch.cummax(torch.where(is_peak, idxs, -1), dim=1).values
    right = torch.cummin(torch.where(is_peak, idxs, 2 * B).flip(1),
                         dim=1).values.flip(1)
    pick = torch.where((idxs - left) <= (right - idxs), left, right)
    pick = torch.where(left < 0, right, pick)
    pick = torch.where(right >= 2 * B, left.clamp(min=0), pick)
    p = pick.clamp(0, B - 1)
    anyp = is_peak.any(dim=1, keepdim=True)              # [F, 1, ch]
    phi_p = phase.gather(1, p)
    inc_p = inc.gather(1, p)

    theta = acc_phase
    out_phase = []
    for k in range(F):
        theta_pk = theta.gather(0, p[k]) + inc_p[k]
        theta = torch.where(anyp[k], theta_pk + (phase[k] - phi_p[k]),
                            theta + inc[k])
        if k == 0 and not primed:
            # stream start / post-seek: synthesis == analysis phase
            theta = phase[0]
        theta = _wrap(theta)
        out_phase.append(theta)
    out_phase = torch.stack(out_phase)

    y = torch.fft.irfft(torch.polar(mag, out_phase), n=N, dim=1)
    y = y * (win[None, :, None] / 1.5)                   # WOLA-normalized
    # overlap-add at hop HS: frame k covers output blocks k..k+3
    yb = y.reshape(F, 4, HS, -1)
    z = torch.zeros((F + 3, HS, y.shape[-1]), dtype=torch.float32, device=dev)
    for j in range(4):
        z[j:j + F] += yb[:, j]
    emit = z[:F].reshape(F * HS, -1)
    emit[: N - HS] += tail
    new_tail = z[F:].reshape(N - HS, -1)
    return emit, phase[-1], theta, new_tail


class TimeStretch:
    """Streaming pitch-preserving tempo change for PCM [n, ch] float32,
    computed on `device`.

    speed > 1 plays faster (shorter output), speed < 1 slower. The
    effective speed is quantized to ha/HOP_SYN (ha integer): at most
    ~0.2% off the request, exact for common values (0.5, 0.75, 1.25,
    1.5, 2.0).
    """

    def __init__(self, channels: int, speed: float = 1.0, device="cuda"):
        self.channels = channels
        self.device = torch.device(device)
        self._buf = np.zeros((0, channels), np.float32)
        self._prev_phase = None   # device [B, ch]
        self._acc_phase = None
        self._tail = None
        self._primed = False
        self.set_speed(speed)

    # ------------------------------------------------------------ state
    @property
    def speed(self) -> float:
        return self._ha / HOP_SYN

    def set_speed(self, speed: float):
        """Change tempo; takes effect at the next processed chunk —
        input already buffered (but not yet drained) is consumed at the
        NEW speed. Carried phase/overlap state is kept, so a mid-stream
        change glides without a click."""
        if not (SPEED_MIN <= speed <= SPEED_MAX):
            raise ValueError(
                f"speed must be in [{SPEED_MIN}, {SPEED_MAX}], got {speed}")
        self._ha = max(1, int(round(HOP_SYN * speed)))

    def reset(self):
        """Discontinuity (seek): drop buffered input and carried state."""
        self._buf = self._buf[:0]
        self._primed = False

    def state_blob(self) -> dict:
        """Host-serializable snapshot, with the JAX package's keys."""
        d = {"ha": self._ha, "buf": self._buf, "primed": self._primed}
        if self._primed:
            d["prev"] = self._prev_phase.cpu().numpy()
            d["acc"] = self._acc_phase.cpu().numpy()
            d["tail"] = self._tail.cpu().numpy()
        return d

    def restore_blob(self, d: dict):
        self._ha = int(d["ha"])
        self._buf = np.asarray(d["buf"], np.float32).reshape(-1, self.channels)
        self._primed = bool(d["primed"])
        if self._primed:
            self._prev_phase, self._acc_phase, self._tail = (
                torch.tensor(np.asarray(d[k], np.float32), device=self.device)
                for k in ("prev", "acc", "tail"))

    # ---------------------------------------------------------- process
    def _need(self) -> int:
        return (F_CHUNK - 1) * self._ha + N_FFT

    def process(self, pcm: np.ndarray) -> np.ndarray:
        """Feed PCM, return whatever stretched PCM is ready (possibly
        empty). Output is chunking-invariant: only full F_CHUNK-frame
        chunks are processed, the residue waits."""
        pcm = np.asarray(pcm, np.float32).reshape(-1, self.channels)
        self._buf = pcm if not len(self._buf) else np.concatenate(
            [self._buf, pcm])
        return self._drain()

    def flush(self) -> np.ndarray:
        """End of stream: zero-pad so every frame whose start lies in
        the buffered residue is emitted, trim the chunk padding's
        surplus, then reset for reuse. Each drained chunk consumed
        F_CHUNK*ha input for F_CHUNK*HOP_SYN output, so the residue's
        ceil(len/ha) frames complete the duration contract (output ==
        input/speed to within one hop)."""
        f_left = -(-len(self._buf) // self._ha)
        if f_left == 0:
            self.reset()
            return np.zeros((0, self.channels), np.float32)
        pad = (-(-f_left // F_CHUNK) * F_CHUNK - 1) * self._ha + N_FFT \
            - len(self._buf)
        if pad > 0:
            self._buf = np.concatenate(
                [self._buf, np.zeros((pad, self.channels), np.float32)])
        out = self._drain()[: f_left * HOP_SYN]
        self.reset()
        return out

    def _drain(self) -> np.ndarray:
        ha, step = self._ha, F_CHUNK * self._ha
        k = 0  # full chunks the buffer holds
        while len(self._buf) >= k * step + self._need():
            k += 1
        if k == 0:
            return np.zeros((0, self.channels), np.float32)
        if not self._primed:
            B = N_FFT // 2 + 1
            z = lambda n: torch.zeros((n, self.channels), dtype=torch.float32,
                                      device=self.device)
            self._prev_phase, self._acc_phase = z(B), z(B)
            self._tail = z(N_FFT - HOP_SYN)
        # one H2D for the k chunks, one D2H for their output
        used = (k - 1) * step + self._need()
        buf = torch.from_numpy(np.ascontiguousarray(self._buf[:used])).to(
            self.device)
        emits = []
        for c in range(k):
            emit, self._prev_phase, self._acc_phase, self._tail = _chunk(
                buf[c * step: c * step + self._need()], ha, self._prev_phase,
                self._acc_phase, self._tail, self._primed)
            self._primed = True
            emits.append(emit)
        self._buf = self._buf[k * step:]
        return torch.cat(emits).cpu().numpy()


def stretch(pcm: np.ndarray, speed: float, device="cuda") -> np.ndarray:
    """Offline convenience: stretch a whole [n, ch] (or [n]) buffer."""
    x = np.asarray(pcm, np.float32)
    mono = x.ndim == 1
    if mono:
        x = x[:, None]
    ts = TimeStretch(x.shape[1], speed, device=device)
    out = np.concatenate([ts.process(x), ts.flush()])
    return out[:, 0] if mono else out
