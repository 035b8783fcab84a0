"""Batched decode pipeline in PyTorch (counterpart of mp3tpu.kernels.pipeline).

One window of granules of S streams at a time:

  plane decode -> C1-C5 (fused_pipeline_z: the CUDA kernel on the card, its
  plain version on the CPU) -> C6-C7 (synth_backend: overlap-add, frequency
  inversion, 16-tap synthesis FIR; the fixed-order CUDA kernel on the card,
  its plain version on the CPU) -> int16

The JAX package's lax.scan programs are Python loops over windows here, each
carrying the decoder state {overlap [S,2,32,18], hist [S,2,15,32]} float32.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..dsp.resample import Resampler
from .fused_z import fused_pipeline_z
from .synth import synth_backend
from .tables import DeviceTables, build_tables


def init_state(n_streams: int, n_channels: int = 2, device="cuda") -> dict:
    """Explicit decoder state carried between windows (float32, tiny)."""
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    return {"overlap": z(n_streams, n_channels, 32, 18),
            "hist": z(n_streams, n_channels, 15, 32)}


class GranuleDecoder(nn.Module):
    """The granule chain C1-C7 of one sample rate (granule_pipeline)."""

    def __init__(self, tables: DeviceTables):
        super().__init__()
        self.tables = tables

    def forward(self, is_, exp, block_type, mixed, smode, state):
        """is_ int [S,G,2,576], exp int [S,G,2,64], block_type int [S,G,2],
        mixed bool [S,G,2], smode uint8 [S,G,64], state from init_state
        -> (pcm float32 [S, G*576, 2], new state)."""
        z = fused_pipeline_z(is_, exp, block_type, mixed, smode, self.tables)
        return synth_backend(z, state, self.tables)


def _device_key(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


_DECODERS: dict = {}
_RESAMPLERS: dict = {}


def decoder_for(sample_rate: int, device) -> GranuleDecoder:
    """The GranuleDecoder of `sample_rate` on `device`, built once."""
    key = (sample_rate, _device_key(device))
    if key not in _DECODERS:
        _DECODERS[key] = GranuleDecoder(build_tables(sample_rate, key[1]))
    return _DECODERS[key]


def resampler_for(sr_in: int, sr_out: int, device) -> Resampler:
    key = (sr_in, sr_out, _device_key(device))
    if key not in _RESAMPLERS:
        _RESAMPLERS[key] = Resampler(sr_in, sr_out, device=key[2])
    return _RESAMPLERS[key]


def quantize_i16(pcm: torch.Tensor) -> torch.Tensor:
    """float PCM in [-1, 1) -> int16, rounding half away from zero (C8);
    torch.round would round half to even."""
    scaled = pcm * 32768.0
    r = torch.where(scaled >= 0, torch.floor(scaled + 0.5),
                    torch.ceil(scaled - 0.5))
    return r.clamp(-32768.0, 32767.0).to(torch.int16)


def decode_window_group(is_, exp, block_type, mixed, smode, state,
                        sample_rate: int, k: int):
    """k windows of G/k granules each, float32 PCM [S, G*576, 2] out: the
    single-stream decode program (the JAX package's group scan)."""
    dec = decoder_for(sample_rate, is_.device)
    win = is_.shape[1] // k
    out = []
    for w in range(k):
        sl = slice(w * win, (w + 1) * win)
        pcm, state = dec(is_[:, sl], exp[:, sl], block_type[:, sl],
                         mixed[:, sl], smode[:, sl], state)
        out.append(pcm)
    return torch.cat(out, dim=1), state


def decode_window(is_, exp, block_type, mixed, smode, state, sample_rate: int):
    """One window of S streams -> (float32 PCM [S, G*576, 2], state)."""
    return decoder_for(sample_rate, is_.device)(is_, exp, block_type, mixed,
                                                smode, state)


def decode_window_i16(is_, exp, block_type, mixed, smode, state,
                      sample_rate: int):
    """One window of S streams -> (int16 PCM [S, G*576, 2], state): the
    scheduler's step."""
    pcm, state = decode_window(is_, exp, block_type, mixed, smode, state,
                               sample_rate)
    return quantize_i16(pcm), state


# ---- packed planes -> symbols (integer-exact)

def _apply_escapes(v, esc_pos, esc_val):
    lines = torch.arange(576, device=v.device)
    for e in range(esc_pos.shape[-1]):
        p = esc_pos[..., e:e + 1].to(torch.int32)
        val = esc_val[..., e:e + 1].to(torch.int32)
        v = torch.where(lines == p, val, v)
    return v


def unpack12(is12, esc_pos, esc_val):
    """12-bit packed spectrum plane uint8 [..., 864] plus escapes
    (line index, -1 = empty; value) [..., 16] -> int32 [..., 576]."""
    u = is12.to(torch.int32).reshape(is12.shape[:-1] + (288, 3))
    a = (u[..., 0] << 4) | (u[..., 1] >> 4)
    b = ((u[..., 1] & 0xF) << 8) | u[..., 2]
    v = torch.stack([a, b], dim=-1).reshape(is12.shape[:-1] + (576,))
    v = v - 4096 * (v >= 2048).to(torch.int32)
    return _apply_escapes(v, esc_pos, esc_val)


def unpack8(is8, esc_pos, esc_val):
    """8-bit signed spectrum plane int8 [..., 576] plus escapes as in
    unpack12 -> int32 [..., 576]."""
    return _apply_escapes(is8.to(torch.int32), esc_pos, esc_val)


def unpack4(is4, esc):
    """4-bit spectrum plane uint8 [..., 288], two lines per byte, nibble =
    value+7 for values in [-7, 7], nibble 15 marks an escape. esc int8
    [..., 80] is the position-free two-level sideband: [:64] escape values
    in line order (-128 marks a deep escape), [64:72]/[72:80] low/high
    bytes of the |v|>127 values, taken by rank among the -128 markers.
    Each rank is a cumsum and each lookup a gather. -> int32 [..., 576]."""
    e8 = esc[..., :64].to(torch.int32)
    deep = e8 == -128
    lo = esc[..., 64:72].to(torch.int32) & 255
    hi = esc[..., 72:80].to(torch.int32)
    big = (hi << 8) + lo
    rank2 = torch.cumsum(deep, dim=-1, dtype=torch.int32) - 1
    deep_val = big.gather(-1, rank2.clamp(0, 7).long())
    esc_val = torch.where(deep, torch.where(rank2 < 8, deep_val, 0), e8)

    u = is4.to(torch.int32)
    nib = torch.stack([u & 15, u >> 4], dim=-1).reshape(is4.shape[:-1] + (576,))
    is_esc = nib == 15
    base = torch.where(is_esc, 0, nib - 7)
    rank = torch.cumsum(is_esc, dim=-1, dtype=torch.int32) - 1
    val = esc_val.gather(-1, rank.clamp(0, 63).long())
    return base + torch.where(is_esc & (rank < 64), val, 0)


def _exp_decode(exp):
    """Compact uint8 [..., 65] exponent plane ([gg, off+128] per
    granule-channel; exp = gg - 210 + off) -> int32 [..., 64]; int16
    planes pass through."""
    if exp.shape[-1] == 65:
        e = exp.to(torch.int32)
        return (e[..., :1] - 210) + (e[..., 1:] - 128)
    return exp


def _plane_decode(plane_bits: int, is12, esc):
    """esc is [..., n, 2] pos/val pairs for the 8/12-bit planes and
    [..., 80] for the 4-bit plane."""
    if plane_bits == 4:
        return unpack4(is12, esc)
    fn = unpack12 if plane_bits == 12 else unpack8
    return fn(is12, esc[..., 0], esc[..., 1])


def _packed_step(dec, plane_bits, is12, esc, exp, bt, mx, sm, state):
    """One packed window [S, win, ...] -> (float32 pcm, new state)."""
    iv = _plane_decode(plane_bits, is12, esc)
    return dec(iv, _exp_decode(exp), bt, mx.bool(), sm, state)


def decode_windows_scan_i16(is12_w, esc_w, exp_w, bt_w, mx_w, sm_w, state,
                            sample_rate: int, plane_bits: int = 4):
    """Packed decode of a window sequence (lists of per-window tensors, all
    [S, win, ...]) -> (int16 PCM [S, n_win*win*576, 2], state)."""
    dec = decoder_for(sample_rate, is12_w[0].device)
    out = []
    for x in zip(is12_w, esc_w, exp_w, bt_w, mx_w, sm_w):
        pcm, state = _packed_step(dec, plane_bits, *x, state)
        out.append(quantize_i16(pcm))
    return torch.cat(out, dim=1), state


_ARENA_PLANES = (("is12", (2, 288), np.uint8), ("esc", (2, 80), np.int8),
                 ("exp", (2, 65), np.uint8), ("bt", (2,), np.int8),
                 ("mx", (2,), np.uint8), ("smode", (64,), np.uint8))


def window_arena_layout(S: int, win: int):
    """(total_bytes, [(key, offset, shape, numpy dtype)]) of one window's
    packed staging arena over the chunk width S (4-bit spectrum, int8
    two-level sideband, byte exponents): ~S*win*934 bytes."""
    out = []
    off = 0
    for k, tail, dt in _ARENA_PLANES:
        shp = (S, win) + tail
        out.append((k, off, shp, dt))
        off += int(np.prod(shp))
    return off, out


def pack_window_arenas(planes: dict, S: int, win: int,
                       out: np.ndarray | None = None) -> np.ndarray:
    """Host side: window-major planes [n_win, S, win, ...] of the 4-bit
    family -> one uint8 arena per window, [n_win, total_bytes], written into
    `out` when given."""
    wb, layout = window_arena_layout(S, win)
    n_win = planes["is12"].shape[0]
    if out is None:
        out = np.empty((n_win, wb), np.uint8)
    for k, off, shp, _dt in layout:
        out[:, off:off + int(np.prod(shp))] = planes[k].reshape(n_win, -1).view(np.uint8)
    return out


def _split_window_arena(a: torch.Tensor, S: int, win: int) -> dict:
    """One uint8 window arena -> the six plane tensors (views)."""
    _, layout = window_arena_layout(S, win)
    parts = {}
    for k, off, shp, dt in layout:
        sec = a[off:off + int(np.prod(shp))]
        if dt != np.uint8:
            sec = sec.view(torch.int8)
        parts[k] = sec.reshape(shp)
    return parts


def decode_window_arenas_i16(arenas, state, sample_rate: int, S: int, win: int):
    """Packed decode of a window sequence staged as per-window byte arenas
    (window_arena_layout; 4-bit plane family only) -> (int16 PCM, state)."""
    dec = decoder_for(sample_rate, arenas[0].device)
    out = []
    for a in arenas:
        p = _split_window_arena(a, S, win)
        pcm, state = _packed_step(dec, 4, p["is12"], p["esc"], p["exp"],
                                  p["bt"], p["mx"], p["smode"], state)
        out.append(quantize_i16(pcm))
    return torch.cat(out, dim=1), state


def init_resample_state(n_streams: int, sample_rate: int,
                        out_rate: int = 48000, n_channels: int = 2,
                        device="cuda") -> torch.Tensor:
    rs = resampler_for(sample_rate, out_rate, device)
    return torch.zeros((n_streams, rs.state_len, n_channels),
                       dtype=torch.float32, device=device)


def decode_all_windows_flat_resampled_i16(is12, exp, esc, bt, mx, sm, state,
                                          rs_state, sample_rate: int,
                                          out_rate: int = 48000,
                                          plane_bits: int = 12):
    """All windows of window-major planes [n_win, S, win, ...], then one
    whole-stream resample of the float32 PCM to `out_rate` (BASELINE
    config 3) -> (int16 [S, out_len, 2], state, new resample history).
    The resample runs once after the loop: given its history it is a
    stateless block-Toeplitz product, so this equals resampling per window."""
    dec = decoder_for(sample_rate, is12.device)
    rs = resampler_for(sample_rate, out_rate, is12.device)
    pcm = []
    for w in range(is12.shape[0]):
        p, state = _packed_step(dec, plane_bits, is12[w], esc[w], exp[w],
                                bt[w], mx[w], sm[w], state)
        pcm.append(p)
    x = torch.cat([rs_state] + pcm, dim=1)                    # [S, N, 2]
    N = x.shape[1]
    out_len = ((N - 1) * rs.L + 1 - rs.n_taps) // rs.M + 1
    nblk = -(-out_len // rs.L)
    npad = (nblk - 1) * rs.M + rs.block_width
    xp = torch.nn.functional.pad(x.transpose(1, 2), (0, max(0, npad - N)))
    out = rs.apply_blocks(xp, nblk)[..., :out_len].transpose(1, 2)
    new_rs_state = x[:, N - rs.state_len:].contiguous() if rs.state_len else rs_state
    return quantize_i16(out), state, new_rs_state
