"""Float64 reference Layer-III decoder (SURVEY.md F4).

Consumes host-unpacked SymbolTensors and runs the spec DSP chain
serially per granule in numpy float64:

  requantize -> stereo mixing -> reorder -> alias reduction ->
  IMDCT/window/overlap-add -> frequency inversion -> polyphase synthesis

This decoder defines ground truth for the TPU kernels (§4.2); it is
itself validated against libmpg123 on crafted and real streams
(tests/test_oracle_mpg123.py).

Copy of mp3tpu.oracle.decoder, kept in the port so that it imports nothing of
the JAX package; the code is the same.
"""
from __future__ import annotations

import numpy as np

from ..bitstream.unpack import SymbolTensors
from ..tables import filterbank as fb
from ..tables import maps as tmaps
from .synth import SynthFIFO


def requantize(is_row: np.ndarray, exp_row: np.ndarray, band_map: np.ndarray) -> np.ndarray:
    """xr[i] = sign(is) |is|^(4/3) 2^(exp[band(i)]/4)  [§2.4.3.4.7.1]."""
    v = is_row.astype(np.float64)
    mag = np.abs(v) ** (4.0 / 3.0)
    e = exp_row[band_map].astype(np.float64)
    return np.sign(v) * mag * np.exp2(0.25 * e)


def alias_reduce(x: np.ndarray, n_boundaries: int) -> np.ndarray:
    """Butterflies across subband boundaries [§2.4.3.4.10.1].
    x: [32, 18] natural-order spectrum (will not be mutated)."""
    if n_boundaries == 0:
        return x
    y = x.copy()
    cs, ca = fb.ALIAS_CS, fb.ALIAS_CA
    for b in range(n_boundaries):
        lo = y[b, 17 - np.arange(8)]
        hi = y[b + 1, np.arange(8)]
        y[b, 17 - np.arange(8)] = lo * cs - hi * ca
        y[b + 1, np.arange(8)] = hi * cs + lo * ca
    return y


class GranuleChain:
    """Stateful per-file decode: overlap-add state + synthesis FIFO."""

    def __init__(self, channels: int, sample_rate: int):
        self.nch = channels
        self.sr = sample_rate
        self.overlap = np.zeros((channels, 32, 18))
        self.fifo = SynthFIFO(channels)
        self.imdct_mats = fb.imdct_block_matrices()
        self.band_maps, self.reorder_maps = tmaps.get_maps(sample_rate)

    def granule(self, st: SymbolTensors, g: int) -> np.ndarray:
        """Decode granule g -> [576, channels] PCM float64."""
        nch = self.nch
        xr = np.zeros((2, 576))
        for ch in range(nch):
            fl = 0 if st.block_type[g, ch] != 2 else (2 if st.mixed[g, ch] else 1)
            bm = self.band_maps[fl]
            xr[ch] = requantize(st.is_[g, ch], st.exp[g, ch], bm)
        # stereo mixing (per band of the transmitted-order spectrum).
        # Band geometry of the *left* channel is used for slot lookup; for
        # conformant streams both channels share block geometry in
        # joint-stereo frames.
        if nch == 2:
            fl0 = 0 if st.block_type[g, 0] != 2 else (2 if st.mixed[g, 0] else 1)
            bm = self.band_maps[fl0]
            M = st.mix[g][bm]          # [576, 2, 2]
            mixed = np.einsum("ijk,ki->ji", M, xr[:, :])
            xr = mixed
        pcm = np.zeros((576, nch))
        for ch in range(nch):
            bt = int(st.block_type[g, ch])
            mixed_flag = bool(st.mixed[g, ch])
            fl = 0 if bt != 2 else (2 if mixed_flag else 1)
            nat = xr[ch][self.reorder_maps[fl]].reshape(32, 18)
            nat = alias_reduce(nat, fb.alias_boundaries(bt, mixed_flag))
            # per-subband windowed IMDCT -> [32, 36]
            z = np.zeros((32, 36))
            for sb in range(32):
                sb_bt = bt
                if bt == 2 and mixed_flag and sb < 2:
                    sb_bt = 0
                z[sb] = nat[sb] @ self.imdct_mats[sb_bt]
            # overlap-add [§2.4.3.4.10.2]
            s = z[:, :18] + self.overlap[ch]
            self.overlap[ch] = z[:, 18:]
            # frequency inversion [§2.4.3.4.10.4]: odd time samples of odd
            # subbands are negated
            s[1::2, 1::2] *= -1.0
            # synthesis: 18 time steps of 32 subband samples
            pcm[:, ch] = self.fifo_step_channel(ch, s)
        return pcm[:, :nch]

    def fifo_step_channel(self, ch: int, s: np.ndarray) -> np.ndarray:
        out = np.zeros(576)
        for t in range(18):
            full = self.fifo.step_one(ch, s[:, t])
            out[t * 32:(t + 1) * 32] = full
        return out


def decode_symbols(st: SymbolTensors) -> np.ndarray:
    """Full-file decode: SymbolTensors -> PCM float64 [n, channels]."""
    chain = GranuleChain(st.channels, st.sample_rate)
    G = st.n_granules
    out = np.zeros((G * 576, st.channels))
    for g in range(G):
        out[g * 576:(g + 1) * 576] = chain.granule(st, g)
    return out
