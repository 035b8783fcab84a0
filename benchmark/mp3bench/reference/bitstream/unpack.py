"""Host unpack: bit-reservoir assembly (B2), scalefactor + Huffman decode
(B3/B4), and dense SymbolTensors packing (B5). This is the single
host->device boundary of the decode path (SURVEY.md §1).

Per granule-channel the device receives only fixed-shape dense arrays:
quantized spectrum, per-band quarter-step exponents, block geometry, and
per-band 2x2 stereo mixing matrices — every branchy, variable-length or
mode-dependent decision is resolved here on the host.

Frozen copy of mp3tpu_torch.bitstream.unpack for the benchmark's plain
reference: it imports nothing of the program, and a change to the program
does not move it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..container import frames as fr
from ..tables import maps as tmaps
from ..tables import stereo_palette as spal
from ..tables.sfb import LONG, SHORT, PRETAB
from .bits import BitReader
from .huffdec import GranuleBits, decode_spectrum
from .scalefactors import Scalefactors, read_scalefactors_lsf, read_scalefactors_mpeg1
from .sideinfo import parse_side_info

# error flag bits (SURVEY.md §5.3 failure taxonomy)
ERR_RESERVOIR = 1
ERR_HUFFMAN_OVERRUN = 2
ERR_CRC = 4
ERR_BAD_DATA = 8


@dataclass
class SymbolTensors:
    """Dense device-ready symbol arrays; leading dim G = granule pairs."""
    is_: np.ndarray        # int16 [G, 2, 576] signed quantized spectrum
    exp: np.ndarray        # int16 [G, 2, 64] quarter-step band exponents
    block_type: np.ndarray  # int8 [G, 2]
    mixed: np.ndarray      # bool [G, 2]
    smode: np.ndarray      # uint8 [G, 64] stereo palette index per band
    errors: np.ndarray     # int16 [G]
    huff_slack: np.ndarray  # int32 [G, 2] leftover part3 bits (diagnostic)
    lines_used: np.ndarray  # int32 [G, 2] decoded spectrum extent
    sample_rate: int
    channels: int
    version: int

    @property
    def n_granules(self) -> int:
        return self.is_.shape[0]

    @property
    def granules_per_frame(self) -> int:
        """2 for MPEG-1, 1 for LSF — the frame grouping the fault
        counters (Metrics.count_symbol_errors) aggregate over."""
        return 2 if self.version == fr.VERSION_MPEG1 else 1

    @property
    def mix(self) -> np.ndarray:
        """float64 [G, 64, 2, 2] mixing matrices (palette-expanded)."""
        return spal.PALETTE[self.smode]

    def slice_granules(self, g0: int, g1: int) -> "SymbolTensors":
        """View of granules [g0, g1) (shares the underlying arrays)."""
        s = slice(g0, g1)
        return SymbolTensors(
            is_=self.is_[s], exp=self.exp[s], block_type=self.block_type[s],
            mixed=self.mixed[s], smode=self.smode[s], errors=self.errors[s],
            huff_slack=self.huff_slack[s], lines_used=self.lines_used[s],
            sample_rate=self.sample_rate, channels=self.channels,
            version=self.version)

    def granules(self, g0: int, g1: int) -> "SymbolTensors":
        """Duck-type parity with SymbolSource.granules (pre-unpacked)."""
        return self.slice_granules(g0, g1)

    @classmethod
    def concat(cls, parts) -> "SymbolTensors":
        """Concatenate along the granule axis (scalar metadata from the
        first part). The single place that enumerates the array fields
        for reassembly — keep in sync with the dataclass."""
        import numpy as np
        first = parts[0]
        cat = lambda f: np.concatenate([getattr(p, f) for p in parts])
        return cls(
            is_=cat("is_"), exp=cat("exp"), block_type=cat("block_type"),
            mixed=cat("mixed"), smode=cat("smode"), errors=cat("errors"),
            huff_slack=cat("huff_slack"), lines_used=cat("lines_used"),
            sample_rate=first.sample_rate, channels=first.channels,
            version=first.version)


def _flavor(block_type: int, mixed: int) -> int:
    if block_type != 2:
        return tmaps.FLAVOR_LONG
    return tmaps.FLAVOR_MIXED if mixed else tmaps.FLAVOR_SHORT


def _band_exponents(g, sf: Scalefactors, sr: int, lsf: bool) -> np.ndarray:
    """Quarter-step exponent per band slot: xr = |is|^(4/3) * 2^(exp/4)
    [ISO 11172-3 §2.4.3.4.7.1]."""
    exp = np.zeros(64, np.int32)
    gg = g.global_gain - 210
    shift = 2 * (g.scalefac_scale + 1)  # half or full steps, in quarters
    pre = sf.preflag * PRETAB
    long_e = gg - shift * (sf.long_sf + pre)
    exp[:22] = long_e
    for w in range(3):
        sub = gg - 8 * g.subblock_gain[w] - shift * sf.short_sf[:, w]
        exp[22 + w * 13: 22 + w * 13 + 13] = sub
    return exp


_SQRT2_INV = np.float64(1.0) / np.sqrt(np.float64(2.0))


def _stereo_modes(h, sf_pair, nonzero_band, lsf) -> np.ndarray:
    """uint8 [64] stereo palette index per band (see tables.stereo_palette)."""
    out = np.zeros(64, np.uint8)
    if h.channels == 1:
        return out
    ms = h.ms_stereo
    ist = h.intensity_stereo
    if ms and not ist:
        out[:] = spal.IDX_MS
        return out
    if not ist:
        return out
    sf_r: Scalefactors = sf_pair[1]
    # intensity bound per "window group": long bands group, short w groups.
    # A band is intensity iff all right-channel bands at or above it
    # (within its group) are zero.
    for slots in (range(22), range(22, 35), range(35, 48), range(48, 61)):
        slots = list(slots)
        nz = [s for s in slots if nonzero_band[s]]
        bound = (slots.index(nz[-1]) + 1) if nz else 0
        for j, slot in enumerate(slots):
            if j < bound:
                out[slot] = spal.IDX_MS if ms else spal.IDX_LR
                continue
            if slot < 22:
                pos = int(sf_r.long_sf[slot])
                illegal = 7 if not lsf else int(sf_r.long_max[slot])
            else:
                w, sb = divmod(slot - 22, 13)
                pos = int(sf_r.short_sf[sb, w])
                illegal = 7 if not lsf else int(sf_r.short_max[sb, w])
            if pos == illegal:
                out[slot] = spal.IDX_MS if ms else spal.IDX_LR
                continue
            if lsf:
                out[slot] = spal.idx_lsf(pos, sf_r.intensity_scale, ms)
            else:
                out[slot] = spal.idx_mpeg1(pos, ms)
    return out


class WindowedUnpacker:
    """Incremental host unpack with explicit carried state (SURVEY.md
    §3.3 `unpack_window`): the bit reservoir is the only cross-frame
    state (scfsi sharing is frame-local), so a stream can be unpacked
    window-by-window in O(window) memory, or started mid-stream after
    seeding the reservoir with the preceding frames' main data."""

    def __init__(self, data: bytes, index: fr.FrameIndex | None = None):
        self.buf = np.frombuffer(data, np.uint8)
        self.index = index if index is not None else fr.scan_frames(self.buf)
        self.lsf = self.index.version != fr.VERSION_MPEG1
        self.sr = self.index.sample_rate
        self.nch = self.index.channels
        self.ngr = 1 if self.lsf else 2
        self.cursor = 0  # next frame to unpack
        self.reservoir = bytearray()
        self.res_trim = 0  # bytes trimmed off the front of `reservoir`

    @property
    def n_frames(self) -> int:
        return self.index.n_frames

    @property
    def n_granules(self) -> int:
        return self.index.n_frames * self.ngr

    def _main_span(self, fi: int) -> tuple[int, int]:
        off = int(self.index.offsets[fi])
        h = self.index.headers[fi]
        start = off + 4 + (2 if h.crc_protected else 0) + h.side_info_bytes
        return start, off + h.frame_bytes

    def main_data_begin(self, fi: int) -> int:
        """Reservoir back-pointer of frame fi (side-info peek)."""
        off = int(self.index.offsets[fi])
        h = self.index.headers[fi]
        si_start = off + 4 + (2 if h.crc_protected else 0)
        r = BitReader(self.buf[si_start: si_start + h.side_info_bytes])
        return r.read(8 if self.lsf else 9)

    def reservoir_start_frame(self, fi: int) -> int:
        """Earliest frame whose main data must be seeded so frame fi's
        reservoir back-pointer resolves (exact, not a heuristic)."""
        need = self.main_data_begin(fi)
        f = fi
        have = 0
        while have < need and f > 0:
            f -= 1
            a, b = self._main_span(f)
            have += b - a
        return f

    def seed(self, f0: int, f1: int) -> None:
        """Append frames [f0, f1) main data to the reservoir WITHOUT
        decoding (seek pre-roll: reservoir refill is byte appends only),
        then position the cursor at f1."""
        for fi in range(f0, f1):
            a, b = self._main_span(fi)
            self.reservoir += bytes(self.buf[a:b])
        if len(self.reservoir) > 4096:
            cut = len(self.reservoir) - 1024
            del self.reservoir[:cut]
            self.res_trim += cut
        self.cursor = f1

    def restart_at(self, f0: int) -> None:
        """Exact mid-stream start: reset, seed the reservoir from the
        frame reservoir_start_frame(f0), leave cursor at f0."""
        self.reservoir = bytearray()
        self.res_trim = 0
        self.cursor = 0
        self.seed(self.reservoir_start_frame(f0), f0)

    def unpack_frames(self, f1: int) -> SymbolTensors:
        """Unpack frames [cursor, f1) -> SymbolTensors with local rows;
        advances the cursor. Bit-identical to the same rows of a
        whole-file unpack (tested)."""
        f0 = self.cursor
        assert f0 <= f1 <= self.index.n_frames
        buf, index = self.buf, self.index
        lsf, sr, nch, ngr = self.lsf, self.sr, self.nch, self.ngr
        G = (f1 - f0) * ngr

        is_ = np.zeros((G, 2, 576), np.int16)
        exp = np.zeros((G, 2, 64), np.int16)
        block_type = np.zeros((G, 2), np.int8)
        mixed = np.zeros((G, 2), bool)
        smode = np.zeros((G, 64), np.uint8)
        errors = np.zeros(G, np.int16)
        huff_slack = np.zeros((G, 2), np.int32)
        lines_used = np.zeros((G, 2), np.int32)

        reservoir = self.reservoir
        prev_sf: dict[int, Scalefactors] = {}  # scfsi carry (frame-local)

        for fi in range(f0, f1):
            off = int(index.offsets[fi])
            h = index.headers[fi]
            si_start = off + 4 + (2 if h.crc_protected else 0)
            r = BitReader(buf[si_start: si_start + h.side_info_bytes])
            si = parse_side_info(r, h)
            crc_ok = fr.check_crc16(buf, off, h)

            main_start = si_start + h.side_info_bytes
            main_bytes = bytes(buf[main_start: off + h.frame_bytes])
            # reservoir bookkeeping: this frame's granule data starts
            # main_data_begin bytes before the end of the accumulated store
            frame_data_start = len(reservoir) + self.res_trim - si.main_data_begin
            reservoir += main_bytes
            underflow = frame_data_start < self.res_trim
            bitpos = (frame_data_start - self.res_trim) * 8

            for gr in range(ngr):
                gidx = (fi - f0) * ngr + gr
                sf_pair = [Scalefactors(), Scalefactors()]
                if not crc_ok:
                    errors[gidx] |= ERR_CRC
                if underflow:
                    errors[gidx] |= ERR_RESERVOIR
                    for ch in range(nch):
                        g = si.granules[gr][ch]
                        block_type[gidx, ch] = g.block_type
                        mixed[gidx, ch] = bool(g.mixed_block_flag)
                    bitpos += sum(si.granules[gr][ch].part2_3_length for ch in range(nch))
                    continue
                for ch in range(nch):
                    g = si.granules[gr][ch]
                    block_type[gidx, ch] = g.block_type
                    mixed[gidx, ch] = bool(g.mixed_block_flag)
                    br = GranuleBits(bytes(reservoir), bitpos, g.part2_3_length)
                    bitpos += g.part2_3_length
                    if lsf:
                        is_int_ch = h.intensity_stereo and ch == 1
                        sf = read_scalefactors_lsf(br, g, is_int_ch)
                    else:
                        sf = read_scalefactors_mpeg1(
                            br, g, si.scfsi[ch], prev_sf.get(ch), gr)
                        if gr == 0:
                            prev_sf[ch] = sf
                    sf_pair[ch] = sf
                    part3 = g.part2_3_length - sf.part2_bits
                    if part3 < 0:
                        errors[gidx] |= ERR_BAD_DATA
                        continue
                    spec, c1end, overrun, slack = decode_spectrum(br, g, sr, lsf, part3)
                    huff_slack[gidx, ch] = slack
                    lines_used[gidx, ch] = c1end
                    if overrun:
                        errors[gidx] |= ERR_HUFFMAN_OVERRUN
                    np.clip(spec, -32768, 32767, out=spec)
                    is_[gidx, ch] = spec.astype(np.int16)
                    exp[gidx, ch] = _band_exponents(g, sf, sr, lsf).astype(np.int16)
                # stereo modes need right-channel band occupancy
                if nch == 2:
                    fl = _flavor(int(block_type[gidx, 1]), int(mixed[gidx, 1]))
                    bm = tmaps.get_maps(sr)[0][fl]
                    nzb = np.zeros(64, bool)
                    nz_lines = np.nonzero(is_[gidx, 1])[0]
                    nzb[bm[nz_lines]] = True
                    smode[gidx] = _stereo_modes(h, sf_pair, nzb, lsf)
            # trim reservoir: keep at most 511 bytes + current frame headroom
            if len(reservoir) > 4096:
                cut = len(reservoir) - 1024
                del reservoir[:cut]
                self.res_trim += cut

        self.cursor = f1
        return SymbolTensors(is_=is_, exp=exp, block_type=block_type, mixed=mixed,
                             smode=smode, errors=errors, huff_slack=huff_slack,
                             lines_used=lines_used, sample_rate=sr,
                             channels=nch, version=index.version)


def unpack(data: bytes, index: fr.FrameIndex | None = None) -> SymbolTensors:
    """Unpack a whole Layer III stream into SymbolTensors."""
    u = WindowedUnpacker(data, index)
    return u.unpack_frames(u.n_frames)

