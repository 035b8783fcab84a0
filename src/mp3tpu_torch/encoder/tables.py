"""The encoder's constant tables of one sample rate, held as buffers of an
nn.Module (the encoder has no learned weights; these are its parameters).

EncoderTables gathers what the JAX package keeps in four places: the
transform's matrices (mp3tpu.encoder.device._consts), psychoacoustic model
2's tables (psymodel.get_model), the rate loops' count tables
(vloop_device._device_consts) and the emitter's code tables
(emit_device._emit_consts). Where the JAX package multiplies by a one-hot
matrix to gather or to sum by band, the port holds the index form: the
count and the emitter read integer tables, and band sums go through
slot_index's padded line lists, which fix the order of every sum.

encoder_tables_numpy(sample_rate) builds every field from the port's own
numpy sources; encoder_tables_from_numpy(arrays) takes the same fields from
the caller (for instance the JAX package's arrays), so that both packages
can run on identical constants.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from ..tables import huffman as ht
from ..tables.sfb import LONG, SLEN1, SLEN2
from .huffcode import _regions_long
from .vcount import N_PLAIN, TABLE_IDS, _hist_matrix, _long_region_tables

N_TABLES = len(TABLE_IDS)

# (field, dtype)
FIELDS = (
    # E1+E2 transform
    ("analysis_fir", torch.float32),   # [16, 32, 32] polyphase FIR taps
    ("mdct", torch.float32),           # [4, 36, 18] windowed MDCT by block type
    ("post", torch.float32),           # [4, 576, 576] alias + reorder by block type
    ("inv_mask", torch.float32),       # [32, 18] frequency inversion signs
    # E3 psychoacoustic model 2
    ("red_l", torch.float32),          # [513, np_l] bin -> partition one-hot
    ("spread_l", torch.float32),       # [np_l, np_l]
    ("red_s", torch.float32),          # [129, np_s]
    ("spread_s", torch.float32),       # [np_s, np_s]
    ("minval_l", torch.float32),       # [np_l]
    ("qthr_l", torch.float32),         # [np_l]
    ("qthr_s", torch.float32),         # [np_s]
    ("w_l", torch.float32),            # [np_l, 21] partition -> long sfb mass
    ("w_s12", torch.float32),          # [np_s, 12]
    ("win_l", torch.float32),          # [1024] Hann
    ("win_s", torch.float32),          # [256]
    # E4 count: bits per clamped pair bin and table; last column = sign bits
    ("m_len", torch.int32),            # [289, T + 1]
    ("xl", torch.int32),               # [T] plain tables code max < xl
    ("linbits", torch.int32),          # [T] escape tables' linbits, else 0
    ("is_esc", torch.bool),            # [T]
    ("r1p", torch.int32),              # [289] long region 0/1 boundary by bv pairs
    ("r2p", torch.int32),              # [289] long region 1/2 boundary
    ("band_of_line", torch.int64),     # [576] long sfb of a line, 21 beyond
    ("wline", torch.int64),            # [576] short: window of a line
    ("sline", torch.int64),            # [576] short: sfb of a line (12 beyond)
    ("c1a_sig", torch.int32),          # [16] count1 table A length + sign bits
    ("c1b_sig", torch.int32),          # [16]
    ("slen1", torch.int32),            # [16]
    ("slen2", torch.int32),            # [16]
    # E5 emitter
    ("lut", torch.int32),              # [T * 256] (length << 19) | code
    ("c1a", torch.int32),              # [16] (length << 19) | code, table A
    ("emit_linbits", torch.int32),     # [T]
    ("esc16", torch.bool),             # [T] xl == 16
    ("emit_r1p", torch.int32),         # [289] _regions_long's boundaries
    ("emit_r2p", torch.int32),         # [289]
    ("r0c_t", torch.int32),            # [289] region0_count by bv pairs
    ("r1c_t", torch.int32),            # [289]
)


def slot_index(slot_of_line: np.ndarray, n_slots: int) -> np.ndarray:
    """[n_slots, widest] int64: the lines of each slot in rising order,
    padded with 576 (the zero column band_sums appends)."""
    lines = [np.nonzero(slot_of_line == s)[0] for s in range(n_slots)]
    width = max(len(l) for l in lines)
    idx = np.full((n_slots, width), 576, np.int64)
    for s, l in enumerate(lines):
        idx[s, : len(l)] = l
    return idx


class EncoderTables(nn.Module):
    """The encoder's constant tables of one sample rate, as registered
    buffers."""

    def __init__(self, arrays: dict, sample_rate: int, device="cuda"):
        super().__init__()
        self.sample_rate = sample_rate
        for name, dtype in FIELDS:
            self.register_buffer(name, torch.as_tensor(
                np.array(arrays[name])).to(device=device, dtype=dtype))
        # the count's layout of m_len: tables outermost, so that the running
        # sum over a row's 288 pairs runs along the innermost dim; int16
        # holds every sum (288 pairs of at most 19 + 2 * 13 bits)
        self.register_buffer("m_len_t",
                             self.m_len.T.contiguous().to(torch.int16))
        # == 18 for the MPEG-1 rates: the switched layouts' region 0
        self.fixed_pairs = int(LONG[sample_rate][8]) // 2
        bol = np.asarray(arrays["band_of_line"])
        flat39 = (np.asarray(arrays["wline"]) * 13
                  + np.asarray(arrays["sline"]))
        for name, idx in (("long_lines", slot_index(bol, 21)),
                          ("short_lines", slot_index(flat39, 39))):
            self.register_buffer(name, torch.as_tensor(idx, device=device))


def band_sums(x: torch.Tensor, lines: torch.Tensor) -> torch.Tensor:
    """x [R, 576] summed over the lines of each slot -> [R, n_slots]. Every
    slot's lines are gathered into a padded row and summed along it, so a
    row's sums do not depend on how many rows the call holds."""
    xz = torch.cat([x, x.new_zeros(x.shape[0], 1)], dim=1)
    return xz[:, lines].sum(dim=2)


@functools.lru_cache(maxsize=None)
def encoder_tables_numpy(sample_rate: int) -> dict:
    """float64/int numpy sources of every field (read-only: the cache hands
    them to every call)."""
    from ..tables import maps as tmaps
    from . import filterbank as efb
    from .psymodel import get_model
    alias_f = efb.forward_alias_matrices()      # [3, 576, 576]
    bm, rm = tmaps.get_maps(sample_rate)
    # inverse reorder as permutation matrices composed with alias
    post = np.zeros((4, 576, 576))
    for bt in range(4):
        flavor = 1 if bt == 2 else 0
        pinv = np.zeros((576, 576))
        pinv[np.arange(576), rm[flavor]] = 1.0
        post[bt] = alias_f[flavor] @ pinv
    inv = np.ones((32, 18))
    inv[1::2, 1::2] = -1.0
    m = get_model(sample_rate)

    _m, _ovp, m_len, _m_bad, _ovb = _hist_matrix()
    T = N_TABLES
    xl = np.zeros(T, np.int32)
    linbits = np.zeros(T, np.int32)
    lut = np.zeros((T, 16, 16), np.int32)     # (len << 19) | code
    emit_linbits = np.zeros(T, np.int32)
    esc16 = np.zeros(T, np.bool_)             # xl == 16: escape branch
    for col, tid in enumerate(TABLE_IDS):
        if tid == 0:
            xl[col] = 1          # codes only zeros
            continue
        lens, codes, x, y, lb = ht.table_arrays(tid)
        xl[col] = x
        linbits[col] = lb if col >= N_PLAIN else 0
        ll = np.asarray(lens).reshape(x, y)
        cc = np.asarray(codes).reshape(x, y)
        lut[col, :x, :y] = (ll.astype(np.int32) << 19) | cc.astype(np.int32)
        esc16[col] = x == 16
        emit_linbits[col] = lb if esc16[col] else 0
    r1p, r2p = _long_region_tables(sample_rate)
    bands = LONG[sample_rate]
    band_of_line = np.zeros(576, np.int64)
    for b in range(21):
        band_of_line[bands[b]:bands[b + 1]] = b
    band_of_line[bands[21]:] = 21
    short_map = tmaps.band_map(sample_rate, tmaps.FLAVOR_SHORT)
    c1a_len = np.asarray(ht.COUNT1A_LENS, np.int32)
    pop4 = np.array([bin(i).count("1") for i in range(16)], np.int32)
    emit_r1p = np.zeros(289, np.int32)
    emit_r2p = np.zeros(289, np.int32)
    r0c_t = np.zeros(289, np.int32)
    r1c_t = np.zeros(289, np.int32)
    for bv in range(289):
        r0c, r1c, r1, r2 = _regions_long(2 * bv, sample_rate)
        emit_r1p[bv], emit_r2p[bv] = r1 // 2, r2 // 2
        r0c_t[bv], r1c_t[bv] = r0c, r1c
    out = dict(
        analysis_fir=efb.analysis_fir(), mdct=efb.mdct_matrices(), post=post,
        inv_mask=inv,
        red_l=m.red_l, spread_l=m.spread_l, red_s=m.red_s,
        spread_s=m.spread_s, minval_l=m.minval_l, qthr_l=m.qthr_l,
        qthr_s=m.qthr_s, w_l=m.w_l, w_s12=m.w_s[:, :12], win_l=m.win_l,
        win_s=m.win_s,
        m_len=m_len.astype(np.int32), xl=xl, linbits=linbits,
        is_esc=np.arange(T) >= N_PLAIN, r1p=r1p, r2p=r2p,
        band_of_line=band_of_line, wline=(short_map - 22) // 13,
        sline=(short_map - 22) % 13, c1a_sig=c1a_len + pop4,
        c1b_sig=4 + pop4, slen1=np.asarray(SLEN1, np.int32),
        slen2=np.asarray(SLEN2, np.int32),
        lut=lut.reshape(-1),
        c1a=(c1a_len << 19) | np.asarray(ht.COUNT1A_CODES, np.int32),
        emit_linbits=emit_linbits, esc16=esc16, emit_r1p=emit_r1p,
        emit_r2p=emit_r2p, r0c_t=r0c_t, r1c_t=r1c_t)
    for a in out.values():
        a.setflags(write=False)
    return out


_CACHE: dict = {}


def encoder_tables(sample_rate: int, device="cuda") -> EncoderTables:
    """The tables of `sample_rate` on `device`, built once per device."""
    key = (sample_rate, str(torch.device(device)))
    if key not in _CACHE:
        _CACHE[key] = EncoderTables(encoder_tables_numpy(sample_rate),
                                    sample_rate, device)
    return _CACHE[key]


def encoder_tables_from_numpy(arrays: dict, sample_rate: int,
                              device="cuda") -> EncoderTables:
    """An EncoderTables from numpy arrays named as FIELDS."""
    return EncoderTables(arrays, sample_rate, device)
