"""Per-samplerate constant tables of the granule chain, held as buffers of an
nn.Module (counterpart of mp3tpu.kernels.pipeline.DeviceTables).

The eight fields of the JAX package's DeviceTables keep their names and
float32 values. Beside them are the index forms that the CUDA kernel and the
plain C1-C5 read where the JAX package multiplies by one-hot matrices: band
and reorder maps per flavor and the alias butterflies; and, on the host, the
IMDCT coefficients the CUDA kernel takes as a launch parameter
(imdct_coefs).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

# (field, dtype); the first eight are DeviceTables' fields in the JAX package
FIELDS = (
    ("band_oh", torch.float32),       # [3, 64, 576] one-hot band -> line
    ("ra", torch.float32),            # [3, 576, 576] reorder + alias composed
    ("imdct_long", torch.float32),    # [18, 36] unwindowed IMDCT-36
    ("imdct_short", torch.float32),   # [18, 36] composite windowed short
    ("windows", torch.float32),       # [4, 36] long windows; row 2 = ones
    ("palette4", torch.float32),      # [144, 4] stereo palette, 2x2 flattened
    ("synth_fir", torch.float32),     # [16, 32, 32] synthesis FIR taps
    ("inv_mask", torch.float32),      # [32, 18] frequency inversion signs
    ("band_map", torch.int32),        # [3, 576] line -> band slot, by flavor
    ("reorder_map", torch.int32),     # [3, 576] natural -> transmitted line
    ("n_alias", torch.int32),         # [3] alias boundaries: 31, 0, 1
    ("alias_cs", torch.float32),      # [8] butterfly coefficients
    ("alias_ca", torch.float32),      # [8]
)


class DeviceTables(nn.Module):
    """The constant tables of one sample rate, as registered buffers."""

    def __init__(self, arrays: dict, device="cuda"):
        super().__init__()
        for name, dtype in FIELDS:
            self.register_buffer(name, torch.as_tensor(
                np.array(arrays[name])).to(device=device, dtype=dtype))
        # the IMDCT coefficients of the CUDA kernel, on the host: it takes
        # them as a launch parameter
        self.imdct_coefs_host = imdct_coefs(self)
        # derived forms for the plain C1-C5 and the synthesis matmul
        partner, self_c, cross_c = _alias_gather(
            np.asarray(arrays["n_alias"]), np.asarray(arrays["alias_cs"]),
            np.asarray(arrays["alias_ca"]))
        self.register_buffer("alias_partner", torch.as_tensor(
            partner, dtype=torch.int64, device=device))
        self.register_buffer("alias_self", torch.as_tensor(
            self_c, dtype=torch.float32, device=device))
        self.register_buffer("alias_cross", torch.as_tensor(
            cross_c, dtype=torch.float32, device=device))
        # synth_w[k*16 + w, j] = synth_fir[15 - w, k, j]: the FIR as one
        # matmul over unfold(time, 16) windows (see synth.synth_backend_reference)
        self.register_buffer("synth_w", self.synth_fir.flip(0).permute(1, 0, 2)
                             .reshape(512, 32).contiguous())
        # the same synthesis taken apart, for the kernel of csrc/synth.cu and
        # synth.synth_backend_factored_reference: the window D [512] and the
        # 32 distinct rows of the matrixing N (SYNTH_V_ROWS)
        window, matrix = _synth_factors()
        self.register_buffer("synth_window", torch.tensor(window, device=device))
        self.register_buffer("synth_matrix", torch.tensor(matrix, device=device))


# the rows of the synthesis matrixing N [64, 32] whose values of V are
# distinct: N[16] = 0, N[32 - i] = -N[i] (i <= 32), N[96 - i] = N[i] (i >= 33)
SYNTH_V_ROWS = tuple(range(16)) + tuple(range(33, 49))


@functools.lru_cache(maxsize=None)
def _synth_factors() -> tuple:
    """float32 (D [512], N[SYNTH_V_ROWS] [32, 32]) from the port's own
    tables/filterbank.py (read-only)."""
    from ..tables import filterbank as fb
    window = fb.synthesis_window().astype(np.float32)
    matrix = fb.synthesis_matrix()[list(SYNTH_V_ROWS)].astype(np.float32)
    for a in (window, matrix):
        a.setflags(write=False)
    return window, matrix


def synth_v_expansion() -> tuple:
    """(src [64], sign [64]): row i of V is sign[i] * P[src[i]], where P
    holds the values of SYNTH_V_ROWS in that order; sign 0 for V[16]."""
    pos = {r: m for m, r in enumerate(SYNTH_V_ROWS)}

    def one(i):
        if i in pos:
            return pos[i], 1.0
        if i == 16:
            return 0, 0.0
        return (pos[32 - i], -1.0) if i < 33 else (pos[96 - i], 1.0)

    src, sign = zip(*map(one, range(64)))
    return list(src), list(sign)


def imdct_coefs(t: DeviceTables) -> torch.Tensor:
    """The 540 float32 coefficients of C5 in csrc/fused_z.cu (ImdctCoefs),
    taken from the plain version's own tables: the 18 distinct columns of
    imdct_long (0-8 and 18-26; the IMDCT-36's symmetry gives the other
    18), one short window's block of imdct_short (lines 0-5 -> outputs
    6-17), and the four long windows."""
    cols = list(range(9)) + list(range(18, 27))
    return torch.cat([t.imdct_long[:, cols].reshape(-1),
                      t.imdct_short[:6, 6:18].reshape(-1),
                      t.windows.reshape(-1)]).cpu().contiguous()


def _alias_gather(n_alias, cs, ca):
    """The alias butterflies of each flavor as out = v*self + v[partner]*cross
    over the 576 natural-order lines: every line has at most one partner."""
    partner = np.tile(np.arange(576), (3, 1))
    self_c = np.ones((3, 576), np.float32)
    cross_c = np.zeros((3, 576), np.float32)
    cs32, ca32 = cs.astype(np.float32), ca.astype(np.float32)
    for f in range(3):
        for b in range(int(n_alias[f])):
            for i in range(8):
                lo, hi = b * 18 + 17 - i, (b + 1) * 18 + i
                partner[f, lo], partner[f, hi] = hi, lo
                self_c[f, lo] = self_c[f, hi] = cs32[i]
                cross_c[f, lo], cross_c[f, hi] = -ca32[i], ca32[i]
    return partner, self_c, cross_c


@functools.lru_cache(maxsize=None)
def _numpy_tables(sample_rate: int) -> dict:
    """float64/int numpy sources of every field, built as the JAX package's
    build_tables builds them (read-only: the cache hands them to every call)."""
    from ..oracle.decoder import alias_reduce
    from ..tables import filterbank as fb
    from ..tables import maps as tmaps
    from ..tables.stereo_palette import PALETTE
    bm, rm = tmaps.get_maps(sample_rate)

    band_oh = np.zeros((3, 64, 576))
    for f in range(3):
        band_oh[f, bm[f], np.arange(576)] = 1.0

    n_alias = np.zeros(3, np.int32)
    n_alias[[tmaps.FLAVOR_LONG, tmaps.FLAVOR_SHORT, tmaps.FLAVOR_MIXED]] = (31, 0, 1)
    ra = np.zeros((3, 576, 576))
    eye = np.eye(576)
    for f in range(3):
        nat = eye[:, rm[f]]
        for r in range(576):
            ra[f, r] = alias_reduce(nat[r].reshape(32, 18), int(n_alias[f])).ravel()

    mats = fb.imdct_block_matrices()
    inv = np.ones((32, 18))
    inv[1::2, 1::2] = -1.0
    out = dict(
        band_oh=band_oh, ra=ra, imdct_long=fb.imdct36_matrix(),
        imdct_short=mats[2],
        windows=np.stack([fb.imdct_window(0), fb.imdct_window(1),
                          np.ones(36), fb.imdct_window(3)]),
        palette4=PALETTE.reshape(-1, 4), synth_fir=fb.synthesis_fir(),
        inv_mask=inv, band_map=bm, reorder_map=rm, n_alias=n_alias,
        alias_cs=fb.ALIAS_CS, alias_ca=fb.ALIAS_CA)
    for a in out.values():
        a.setflags(write=False)
    return out


def build_tables(sample_rate: int, device="cuda") -> DeviceTables:
    """The tables of `sample_rate` on `device`."""
    return DeviceTables(_numpy_tables(sample_rate), device)


def tables_from_numpy(arrays: dict, device="cuda") -> DeviceTables:
    """A DeviceTables from numpy arrays named as FIELDS (for instance the
    JAX package's tables, completed with the index forms)."""
    return DeviceTables(arrays, device)


def tables_to_numpy(tables: DeviceTables) -> dict:
    return {name: getattr(tables, name).cpu().numpy() for name, _ in FIELDS}


def state_from_numpy(state, device="cuda"):
    """Numpy (or JAX) arrays -> float32 tensors on `device`, keeping the
    structure: a dict (the decoder state {overlap, hist}), a bare array (the
    resample history [S, state_len, 2]) or a tuple (a Resampler's
    (carry, n_in, n_out), whose counts stay ints)."""
    if isinstance(state, dict):
        return {k: state_from_numpy(v, device) for k, v in state.items()}
    if isinstance(state, tuple):
        return tuple(state_from_numpy(v, device) for v in state)
    if isinstance(state, (int, np.integer)):
        return int(state)
    return torch.tensor(np.asarray(state, np.float32), device=device)


def state_to_numpy(state):
    """Inverse of state_from_numpy."""
    if isinstance(state, dict):
        return {k: state_to_numpy(v) for k, v in state.items()}
    if isinstance(state, tuple):
        return tuple(state_to_numpy(v) for v in state)
    if isinstance(state, int):
        return state
    return state.detach().cpu().numpy()
