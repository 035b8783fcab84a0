"""The Layer III granule chain in plain torch, vectorised over granules.

ISO/IEC 11172-3 §2.4.3.4: requantise -> stereo mixing -> reorder -> alias
reduction -> windowed IMDCT -> overlap-add -> frequency inversion ->
polyphase synthesis (§2.4.3.2.2, the V-FIFO written as a 16-tap sum over
time steps). It reads the symbols of the frozen Python unpacker
(bitstream/unpack.py) and nothing of the program.

`precision` is that of every step: "float64" is the reference. The program
states float32 with TF32 off, so the control is "tf32": float32, with the
operands of every matrix product rounded to TF32's 10-bit mantissa, as a
card's tensor cores take them (done here by hand, so that the control reads
the same on the CPU and on the card).
"""
from __future__ import annotations

import numpy as np
import torch

from .tables import filterbank as fb
from .tables import maps as tmaps
from .tables import stereo_palette as spal

DECODER_DELAY = 529


PRECISIONS = {"float64": torch.float64, "tf32": torch.float32}


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _flavor(bt: torch.Tensor, mixed: torch.Tensor) -> torch.Tensor:
    """Block flavor per granule-channel: 0 long, 1 short, 2 mixed."""
    return torch.where(bt != 2, 0, torch.where(mixed, 2, 1))


def granule_chain(st, precision: str = "float64",
                  device="cpu") -> torch.Tensor:
    """SymbolTensors -> PCM [G*576, channels] at `precision`: every granule
    of the stream from a zero decoder state."""
    dtype = PRECISIONS[precision]
    mm = _tf32 if precision == "tf32" else (lambda a: a)
    nch = st.channels
    G = st.n_granules
    t = lambda a, dt=None: torch.as_tensor(np.asarray(a), device=device,
                                           dtype=dt)
    band_maps, reorder_maps = (t(m, torch.long)
                               for m in tmaps.get_maps(st.sample_rate))
    is_ = t(st.is_[:, :nch], dtype)                        # [G, c, 576]
    exp = t(st.exp[:, :nch]).long()                        # [G, c, 64]
    bt = t(st.block_type[:, :nch]).long()                  # [G, c]
    mixed = t(st.mixed[:, :nch])
    fl = _flavor(bt, mixed)

    # requantise [§2.4.3.4.7.1]: sign(is) |is|^(4/3) 2^(exp/4)
    e = torch.gather(exp, 2, band_maps[fl])                # [G, c, 576]
    xr = torch.sign(is_) * is_.abs() ** (4.0 / 3.0) \
        * torch.exp2(0.25 * e.to(dtype))
    if nch == 2:
        # per band of the left channel's geometry: out[j] = sum_k M[j, k] x[k]
        bm = band_maps[fl[:, 0]]                           # [G, 576]
        pal = t(spal.PALETTE, dtype)[t(st.smode).long()]   # [G, 64, 2, 2]
        M = torch.gather(pal, 1, bm[:, :, None, None].expand(-1, -1, 2, 2))
        xr = torch.einsum("gijk,gki->gji", mm(M), mm(xr))

    # reorder to subband-natural order [§2.4.3.4.8]
    nat = torch.gather(xr, 2, reorder_maps[fl]).reshape(G, nch, 32, 18)

    # alias reduction [§2.4.3.4.10.1]: 31 boundaries for long blocks, 1 for
    # mixed, 0 for short; the butterflies of different boundaries touch
    # different lines, so they run at once
    nb = torch.where(bt != 2, 31, torch.where(mixed, 1, 0))  # [G, c]
    live = (torch.arange(31, device=device)[None, None] < nb[..., None])
    live = live[..., None]                                 # [G, c, 31, 1]
    cs, ca = t(fb.ALIAS_CS, dtype), t(fb.ALIAS_CA, dtype)
    k = torch.arange(8, device=device)
    lo = nat[:, :, :31, 17 - k]
    hi = nat[:, :, 1:, k]
    y = nat.clone()
    y[:, :, :31, 17 - k] = torch.where(live, lo * cs - hi * ca, lo)
    y[:, :, 1:, k] = torch.where(live, hi * cs + lo * ca, hi)

    # windowed IMDCT [§2.4.3.4.10.2-3]; the two lowest subbands of a mixed
    # block are long
    sb_bt = bt[:, :, None].expand(-1, -1, 32).clone()
    sb_bt[:, :, :2] = torch.where((bt == 2) & mixed, 0, bt)[:, :, None]
    mats = t(fb.imdct_block_matrices(), dtype)             # [4, 18, 36]
    rows = y.reshape(-1, 18)
    which = sb_bt.reshape(-1)
    z = torch.zeros(rows.shape[0], 36, dtype=dtype, device=device)
    for b in range(4):
        sel = which == b
        if bool(sel.any()):
            z[sel] = mm(rows[sel]) @ mm(mats[b])
    z = z.reshape(G, nch, 32, 36)

    # overlap-add with the previous granule's tail, then frequency inversion
    tail = torch.cat([torch.zeros_like(z[:1, :, :, 18:]), z[:-1, :, :, 18:]])
    s = z[:, :, :, :18] + tail                             # [G, c, 32, 18]
    s[:, :, 1::2, 1::2] = -s[:, :, 1::2, 1::2]

    # polyphase synthesis: V_t = N S_t, and sample k of step t is
    # sum_m D[32 m + k] V_{t-m}[32 (m % 2) + k]
    S = s.permute(1, 0, 3, 2).reshape(nch, G * 18, 32)     # [c, T, 32]
    V = mm(S) @ mm(t(fb.synthesis_matrix(), dtype).T)    # [c, T, 64]
    T = V.shape[1]
    Vp = torch.cat([torch.zeros(nch, 15, 64, dtype=dtype, device=device), V], 1)
    D = t(fb.synthesis_window(), dtype).reshape(16, 32)
    out = torch.zeros(nch, T, 32, dtype=dtype, device=device)
    for m in range(16):
        lo_ = 32 * (m % 2)
        out = out + D[m] * Vp[:, 15 - m: 15 - m + T, lo_: lo_ + 32]
    return out.reshape(nch, T * 32).T


def to_int16(pcm: torch.Tensor) -> np.ndarray:
    """float PCM in [-1, 1) -> int16, rounding half away from zero and
    clamping: the contract of the program's int16 output."""
    x = pcm.double() * 32768.0
    r = torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))
    return r.clamp(-32768, 32767).to(torch.int16).cpu().numpy()


def gapless_bounds(n: int, encoder_delay: int, encoder_padding: int) -> tuple:
    """(start, end) of the playable samples of n decoded ones, by a LAME
    tag's delay and padding and the decoder's 529-sample delay."""
    start = encoder_delay + DECODER_DELAY
    end = max(n - max(encoder_padding - DECODER_DELAY, 0), start)
    return start, min(end, n)
