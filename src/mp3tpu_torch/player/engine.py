"""Player/session engine (counterpart of mp3tpu.player.engine).

Headless play/seek/loop engine for repeat listening: open -> play / seek(t)
/ loop(a, b) / stop, with exact-sample seek (a one-window pre-roll rebuilds
the decoder state) and checkpoint/resume through snapshot()/restore(), whose
blobs are the JAX package's.

The file is decoded in fixed partitions of WINDOW_GRANULES granules, grouped
GROUP_WINDOWS windows per group, exactly as pipeline.decode_file decodes
it: every window goes through the same GranuleDecoder call at the same
shapes, so play, seek + play and decode give bit-identical PCM. The emitted
PCM passes the gain ramp, the EQ and the int16 quantize on the device
(_emit_dsp), and only int16 crosses to the host.
"""
from __future__ import annotations

import io
from dataclasses import dataclass

import numpy as np
import torch

from ..bitstream.unpack import SymbolTensors
from ..container import frames as fr
from ..container.id3 import Id3Info, parse_id3v1, parse_id3v2
from ..container.seek import SeekTable
from ..container.xing import StreamInfo
from ..dsp.eq import fir_valid
from ..dsp.gain import gain_ramp
from ..dsp.gapless import gapless_bounds
from ..kernels import pipeline as kp
from ..kernels.tables import state_from_numpy
from ..metrics import Metrics, record_resyncs, record_symbol_errors
from ..transfer import HostCopy
from .sink import CollectSink, Sink, take_underruns

WINDOW_GRANULES = 32  # must match pipeline.WINDOW for bit-identity
GROUP_WINDOWS = 8     # must match pipeline.GROUP_WINDOWS


GAIN_RAMP = 256  # samples of linear amplitude ramp on a gain change


def _emit_dsp(x, gain0: float, gain1: float, eq_state, kernel):
    """gain -> EQ (FIR) -> int16 of one block x [n, ch] float32 on the
    device. A length-1 kernel means "no EQ". A gain change ramps linearly
    over GAIN_RAMP samples; with gain0 == gain1 the ramp is exactly
    constant, so at unity gain the output equals a plain quantize.
    Returns (int16 [n, ch], new EQ tail)."""
    x = x * gain_ramp(gain0, gain1, x.shape[0], GAIN_RAMP, x.device)[:, None]
    if kernel.shape[-1] > 1:
        xx = torch.cat([eq_state, x], dim=0)
        x = fir_valid(xx, kernel)
        new_state = xx[-(kernel.shape[-1] - 1):]
    else:
        new_state = eq_state
    return kp.quantize_i16(x), new_state


def _emit_dsp_multi(prev, cur, off: int, gain0: float, gain1: float, eq_state,
                    kernel, nch: int, e: int, m: int):
    """Device-resident emit: m consecutive e-sample blocks starting `off`
    samples into group buffer `prev`, spilling into group `cur` (the same
    buffer twice when the blocks fit one group). Each block runs _emit_dsp,
    with the EQ tail and the gain ramp's completion carried block to block,
    as m calls of the per-block path would. Returns (int16 [m, e, nch],
    the EQ tail after each block, the final tail)."""
    cat = torch.cat([prev[:, :nch], cur[:, :nch]], dim=0)
    i16s, eqs = [], []
    eq, g0 = eq_state, gain0
    for i in range(m):
        x = cat[off + i * e: off + (i + 1) * e]
        i16, eq = _emit_dsp(x, g0, gain1, eq, kernel)
        g0 = gain1
        i16s.append(i16)
        eqs.append(eq)
    return torch.stack(i16s), eqs, eq


@dataclass
class Track:
    """Parsed container + streaming symbol source for one stream (the
    source unpacks granule windows on demand)."""
    source: object  # SymbolSource (duck-typed with SymbolTensors)
    index: fr.FrameIndex
    id3: Id3Info
    id3v1: dict
    stream_info: StreamInfo
    seek_table: SeekTable
    first_audio_frame: int = 0

    @property
    def sample_rate(self) -> int:
        return self.source.sample_rate

    @property
    def channels(self) -> int:
        return self.source.channels


def open_track(path_or_bytes) -> Track:
    from ..pipeline import load_source
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    id3 = parse_id3v2(data)
    id3v1 = parse_id3v1(data)
    source, info, index = load_source(data)
    return Track(source=source, index=index, id3=id3, id3v1=id3v1,
                 stream_info=info, seek_table=SeekTable(index, info),
                 first_audio_frame=0)


class Player:
    """Single-stream playback session on `device`."""

    def __init__(self, path_or_bytes, sink: Sink | None = None,
                 gain_db: float | None = None, eq_gains_db=None,
                 apply_gapless: bool = True, speed: float | None = None,
                 device="cuda"):
        from ..config import get_active
        cfg = get_active()
        if cfg.decode.window_granules != WINDOW_GRANULES:
            # the shared 32-granule partition is the bit-identity contract
            # between play, seek and decode
            raise ValueError(
                "Player requires decode.window_granules == "
                f"{WINDOW_GRANULES} (got {cfg.decode.window_granules})")
        if gain_db is None:
            gain_db = cfg.player.gain_db
        if eq_gains_db is None and cfg.player.eq_gains_db:
            eq_gains_db = list(cfg.player.eq_gains_db)
        self.device = torch.device(device)
        self.track = open_track(path_or_bytes)
        self.sink = sink or CollectSink()
        self.metrics = Metrics()
        record_resyncs(self.track.index.resyncs, self.metrics)
        self.gain_db = gain_db
        self._applied_gain_db = gain_db  # last gain the DSP chain emitted at
        self._eq = None
        self._eq_state = None
        if eq_gains_db is not None:
            from ..dsp.eq import GraphicEQ
            self._eq = GraphicEQ(eq_gains_db, self.track.sample_rate,
                                 device=self.device)
        self._speed = 1.0
        self._stretch = None  # TimeStretch, active iff a speed was set
        # pending-emission state exists before set_speed below: a speed
        # that quantizes to unity takes set_speed's flushing branch
        self._pending: list = []      # PCM awaiting block-aligned emission
        self._pending_n = 0
        if speed is None:
            speed = cfg.player.speed
        if speed != 1.0:
            self.set_speed(speed)
        st = self.track.source
        self.ngr_per_frame = 1 if st.version != fr.VERSION_MPEG1 else 2
        self.spf = 576  # samples per granule
        info = self.track.stream_info
        if apply_gapless and info.gapless:
            total = st.n_granules * self.spf
            self._start, self._end = gapless_bounds(
                total, info.encoder_delay, info.encoder_padding)
        else:
            self._start, self._end = 0, st.n_granules * self.spf
        self._pos = self._start       # absolute decoded-sample position
        self._state = None
        self._state_granule = None    # granule the decoder state is valid for
        # decoded groups kept on the device, newest last, at most two (a
        # loop() segment across a group boundary stays cached):
        #   q -> [device_pcm [K*32*576, 2], n_valid_granules,
        #         upto_windows, host_pcm_or_None]
        self._group_cache: dict = {}
        # symbols of ONE group, accumulated so that a group decoded in
        # growing prefixes unpacks each granule once
        self._group_syms = None       # (q, SymbolTensors, n_granules)
        self._err_counted = {}        # group q -> granules already booked
        self._segments = None         # (param_key, [(start_s, end_s)])
        self.stopped = False

    # ------------------------------------------------------------- info
    @property
    def duration(self) -> float:
        return (self._end - self._start) / self.track.sample_rate

    @property
    def position(self) -> float:
        return (self._pos - self._start) / self.track.sample_rate

    @property
    def metadata(self) -> dict:
        md = dict(self.track.id3.frames)
        for k, v in self.track.id3v1.items():
            md.setdefault(f"v1:{k}", v)
        return md

    # ------------------------------------------------------------ decode
    def _group_symbols(self, q: int, n: int):
        """Symbols for the first n granules of group q, accumulated
        incrementally (SymbolSource does not cache)."""
        src = self.track.source
        GG = GROUP_WINDOWS * WINDOW_GRANULES
        g0 = q * GG
        cached = self._group_syms
        if cached is not None and cached[0] == q and cached[2] >= n:
            return cached[1].slice_granules(0, n) if cached[2] != n else cached[1]
        with self.metrics.span("host"):
            if cached is not None and cached[0] == q:
                ext = src.granules(g0 + cached[2], g0 + n)
                st = SymbolTensors.concat([cached[1], ext])
            else:
                st = src.granules(g0, g0 + n)
        # fault books count each granule once per player: a replay or a
        # backward seek re-unpacks evicted groups
        c = self._err_counted.get(q, 0)
        if n > c:
            record_symbol_errors(st.errors[c:], st.granules_per_frame,
                                 self.metrics)
            self._err_counted[q] = n
        self._group_syms = (q, st, n)
        return st

    def _decode_windows(self, st, n_win: int, state):
        """The first n_win windows of symbols st (zero-padded to whole
        windows) from `state` -> (float32 PCM [n_win*32*576, 2], state)."""
        n = n_win * WINDOW_GRANULES

        def prep(a):
            a = a[:n]
            if len(a) != n:  # the end of the stream
                a = np.pad(a, ((0, n - len(a)),) + ((0, 0),) * (a.ndim - 1))
            return torch.from_numpy(np.ascontiguousarray(a[None])).to(self.device)

        pcm, state = kp.decode_window_group(
            prep(st.is_), prep(st.exp), prep(st.block_type), prep(st.mixed),
            prep(st.smode), state, st.sample_rate, n_win)
        return pcm[0], state

    def _decode_group_dev(self, q: int, upto: int):
        """Decode the first `upto` windows of group q; the decoder state
        must sit at the group start. Returns (device PCM [GROUP*32*576, 2],
        zero past the decoded windows, n_valid_granules). The state
        advances to group q+1 only when the whole group was decoded."""
        src = self.track.source
        W, K = WINDOW_GRANULES, GROUP_WINDOWS
        GG = K * W
        g0 = q * GG
        if self._state is None or self._state_granule != g0:
            raise RuntimeError(f"decoder state is not at group {q}")
        n_avail = min(GG, src.n_granules - g0)
        n = min(upto * W, n_avail)
        st = self._group_symbols(q, n)
        n_win = -(-n // W)
        pcm, new_state = self._decode_windows(st, n_win, self._state)
        if n == GG:  # full real group: state is valid at q+1
            self._state = new_state
            self._state_granule = g0 + GG
        self.metrics.granules_decoded += n
        dev = torch.zeros((GG * self.spf, 2), dtype=torch.float32,
                          device=self.device)
        dev[: len(pcm)] = pcm
        self._group_cache.pop(q, None)
        self._group_cache[q] = [dev, n, n_win, None]
        while len(self._group_cache) > 2:  # evict oldest
            self._group_cache.pop(next(iter(self._group_cache)))
        return dev, n

    def _cached_or_decode_group(self, q: int):
        """Fully decoded device PCM of group q, from the two-entry group
        cache when it covers every available granule, else decoded."""
        src = self.track.source
        GG = GROUP_WINDOWS * WINDOW_GRANULES
        n_avail = min(GG, src.n_granules - q * GG)
        c = self._group_cache.get(q)
        if c is not None and c[1] >= n_avail:
            return c[0]
        self._ensure_state_at_group(q)
        dev, _n = self._decode_group_dev(q, GROUP_WINDOWS)
        return dev

    def _window_pcm(self, w: int) -> np.ndarray:
        """Host float32 PCM of window w, sliced from one host copy of its
        group. The first touch of a group decodes the windows up to w (the
        O(window) first-audio path); any later growth decodes the whole
        group."""
        src = self.track.source
        W, K = WINDOW_GRANULES, GROUP_WINDOWS
        q, wi = divmod(w, K)
        c = self._group_cache.get(q)
        if c is None or c[2] <= wi:
            self._ensure_state_at_group(q)
            self._decode_group_dev(q, wi + 1 if c is None else K)
            c = self._group_cache[q]
        dev, n_valid, _upto, host = c
        n = min(W, n_valid - wi * W)
        if n <= 0:
            return np.zeros((0, src.channels), np.float32)
        if host is None:  # one download per decoded group, reused
            host = dev.cpu().numpy()
            c[3] = host
        return host[wi * W * 576: wi * W * 576 + n * 576, : src.channels]

    def _ensure_state_at_group(self, q: int):
        """Make the decoder state valid at group q's start: either it is
        there, or reset and pre-roll. The state after a window depends only
        on that window's symbols (overlap and history are tails of its own
        output), so the pre-roll decodes one window, the last of group
        q-1."""
        W, K = WINDOW_GRANULES, GROUP_WINDOWS
        g0 = q * K * W
        if self._state is not None and self._state_granule == g0:
            return
        self._state = kp.init_state(1, device=self.device)
        self._state_granule = 0
        if q > 0:
            with self.metrics.span("host"):
                st = self.track.source.granules(g0 - W, g0)
            _pcm, self._state = self._decode_windows(st, 1, self._state)
            self._state_granule = g0
        self.metrics.seeks += 1

    EMIT_BLOCK = WINDOW_GRANULES * 576  # fixed emit block

    def _emit(self, pcm: np.ndarray):
        """Queue PCM and emit it in EMIT_BLOCK blocks; the tail is flushed
        when playback reaches its end. With a speed set, decoded PCM first
        passes the streaming phase vocoder, which holds its own residue,
        so this call may queue nothing."""
        if self._stretch is not None:
            pcm = self._stretch.process(pcm)
            if not len(pcm):
                return
        self._pending.append(pcm)
        self._pending_n += len(pcm)
        while self._pending_n >= self.EMIT_BLOCK:
            buf = (np.concatenate(self._pending) if len(self._pending) > 1
                   else self._pending[0])
            block, rest = buf[: self.EMIT_BLOCK], buf[self.EMIT_BLOCK:]
            self._pending = [rest] if len(rest) else []
            self._pending_n = len(rest)
            self._emit_block(block)

    def _flush_pending(self):
        if self._pending_n:
            buf = (np.concatenate(self._pending) if len(self._pending) > 1
                   else self._pending[0])
            self._pending = []
            self._pending_n = 0
            self._emit_block(buf)

    def _dsp_args(self, nch: int):
        """(gain0, gain1, eq_state, kernel) for the next emit."""
        gain0 = float(np.float32(10.0 ** (self._applied_gain_db / 20.0)))
        gain1 = float(np.float32(10.0 ** (self.gain_db / 20.0)))
        if self._eq is not None:
            if self._eq_state is None:
                self._eq_state = self._eq.init_state(nch)
            return gain0, gain1, self._eq_state, self._eq.h
        return (gain0, gain1,
                torch.zeros((0, nch), dtype=torch.float32, device=self.device),
                torch.ones((1,), dtype=torch.float32, device=self.device))

    def _emit_block(self, pcm: np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(pcm, np.float32)).to(self.device)
        gain0, gain1, eq_state, kernel = self._dsp_args(pcm.shape[1])
        i16, new_eq_state = _emit_dsp(x, gain0, gain1, eq_state, kernel)
        self._applied_gain_db = self.gain_db
        if self._eq is not None:
            self._eq_state = new_eq_state
        self._push_i16(i16.cpu().numpy())

    def _push_i16(self, i16: np.ndarray):
        self.sink.push(i16)
        self.metrics.samples_out += len(i16)
        u = take_underruns(self.sink)
        if u:  # sink-level starvation into the books
            from ..metrics import record_underruns
            record_underruns(u, self.metrics)

    def _emit_multi_dev(self, prev, cur, off: int, m: int):
        """m EMIT_BLOCKs through the device-resident DSP chain (the values
        of _emit_block without the float32 round trip through the host).
        Returns (int16 [m, E, nch] on the device, per-block EQ tails)."""
        nch = self.track.source.channels
        gain0, gain1, eq_state, kernel = self._dsp_args(nch)
        i16s, eqs, eq_fin = _emit_dsp_multi(
            prev, cur, off, gain0, gain1, eq_state, kernel, nch,
            self.EMIT_BLOCK, m)
        self._applied_gain_db = self.gain_db
        if self._eq is not None:
            self._eq_state = eq_fin
        return i16s, eqs

    # -------------------------------------------------------------- api
    def play(self, until_sample: int | None = None, max_samples: int | None = None):
        """Decode from the current position to `until_sample` (absolute,
        default end), pushing int16 PCM to the sink. `max_samples` bounds
        how many SOURCE samples this call advances, which is also what it
        returns; with a speed set the sink receives ~1/speed times as many
        stretched samples.

        Whole EMIT_BLOCKs go through the device path (_play_blocks_device:
        PCM stays on the device through the DSP chain, one int16 download
        per multi-block emit, one emit in flight behind the pushes); the
        sub-block tail, sub-block requests and stretched play take the
        host path. Both run the same decode and the same _emit_dsp."""
        boundary = (self._end if until_sample is None
                    else min(until_sample, self._end))
        end = boundary
        if max_samples is not None:
            end = min(end, self._pos + max_samples)
        wspan = WINDOW_GRANULES * self.spf
        emitted = 0
        hit_eof = False
        self.stopped = False
        if (not self._pending_n and self.EMIT_BLOCK == wspan
                and end - self._pos >= self.EMIT_BLOCK
                and self._stretch is None):
            emitted += self._play_blocks_device(end)
        while self._pos < end and not self.stopped:
            w = self._pos // wspan
            pcm = self._window_pcm(w)
            if len(pcm) == 0:
                hit_eof = True
                break
            lo = self._pos - w * wspan
            hi = min(len(pcm), end - w * wspan)
            if hi > lo:
                self._emit(pcm[lo:hi])
                emitted += hi - lo
            self._pos = min((w + 1) * wspan, end)
        # a play that reached its endpoint delivers the vocoder's held
        # tail; a paced call or a stop() keeps the stretcher streaming
        if (self._stretch is not None and not self.stopped
                and (hit_eof or self._pos >= boundary)):
            tail = self._stretch.flush()
            if len(tail):
                self._pending.append(tail)
                self._pending_n += len(tail)
        self._flush_pending()
        return emitted

    def _push_blocks(self, inflight):
        """Push one downloaded multi-block emit; a stop() from a sink
        callback between blocks leaves the cursor after the last delivered
        block and rewinds the EQ tail to that boundary. Returns (samples,
        interrupted)."""
        host, eqs, _eq_before, _gain_before, m = inflight
        arr = host.numpy()
        E = self.EMIT_BLOCK
        for j in range(m):
            self._push_i16(arr[j])
            self._pos += E
            if self.stopped and j + 1 < m:
                if self._eq is not None:
                    self._eq_state = eqs[j]
                return (j + 1) * E, True
        return m * E, False

    def _play_blocks_device(self, end: int) -> int:
        """Emit every whole EMIT_BLOCK in [self._pos, end) through the
        device group path: one decode per GROUP_WINDOWS windows, one emit
        and one int16 download per up to GROUP_WINDOWS blocks, with the
        next emit enqueued before the previous one is pushed. self._pos
        advances per pushed block; on a stop() the emit in flight is
        discarded and its DSP state unwound."""
        E = self.EMIT_BLOCK
        GG = GROUP_WINDOWS * WINDOW_GRANULES
        gspan = GG * self.spf
        dpos = self._pos  # emit cursor (one emit ahead of _pos)
        q = dpos // gspan
        cur_grp = self._cached_or_decode_group(q)
        nxt_grp = None
        inflight = None  # (host copy, eqs, eq_before, gain_before, m)
        interrupted = False
        emitted = 0
        while not self.stopped:
            blocks_left = (end - dpos) // E
            if blocks_left <= 0:
                break
            off = dpos - q * gspan
            m = min(GROUP_WINDOWS, blocks_left)
            eq_before = self._eq_state
            gain_before = self._applied_gain_db
            if off + m * E > gspan and nxt_grp is None:
                nxt_grp = self._cached_or_decode_group(q + 1)
            i16s, eqs = self._emit_multi_dev(
                cur_grp, cur_grp if nxt_grp is None else nxt_grp, off, m)
            host = HostCopy(i16s)
            if inflight is not None:
                got, interrupted = self._push_blocks(inflight)
                emitted += got
            dpos += m * E
            if dpos >= (q + 1) * gspan:  # m*E <= gspan: at most one cross
                q += 1
                if nxt_grp is not None:
                    cur_grp, nxt_grp = nxt_grp, None
                elif (end - dpos) // E > 0 and not self.stopped:
                    # the emit ended exactly on the boundary
                    cur_grp = self._cached_or_decode_group(q)
            inflight = (host, eqs, eq_before, gain_before, m)
        if inflight is not None:
            if self.stopped:
                # the look-ahead emit was never pushed: the applied gain
                # rolls back to what the last pushed emit left; the EQ
                # tail too, unless an interrupted push already rewound it
                self._applied_gain_db = inflight[3]
                if not interrupted:
                    self._eq_state = inflight[2]
            else:
                got, _ = self._push_blocks(inflight)
                emitted += got
        return emitted

    def seek(self, seconds: float):
        """Exact-sample seek (the symbols carry their full reservoir
        context; the filterbank state is rebuilt by a one-window
        pre-roll)."""
        sample = self._start + int(round(seconds * self.track.sample_rate))
        self._pos = max(self._start, min(sample, self._end))
        # playback is discontinuous: drop queued PCM, reset the EQ tail
        # and the vocoder's carried state (its speed is kept)
        self._pending = []
        self._pending_n = 0
        self._eq_state = None
        if self._stretch is not None:
            self._stretch.reset()

    def loop(self, a: float, b: float, times: int = 1):
        """Repeat-listen the segment [a, b) seconds `times` times."""
        for _ in range(times):
            self.seek(a)
            end = self._start + int(round(b * self.track.sample_rate))
            self.play(until_sample=end)

    def segments(self, refresh: bool = False, **kw) -> list:
        """Sentence boundaries [(start_s, end_s), ...] on the playback
        timeline, from silence analysis (dsp/segment.py) of the same
        window decode the player plays from; only the envelope is kept on
        the host. Cached per parameter set; the cursor is untouched."""
        from ..dsp.segment import (HOP_S, env_db_from_power, sample_power,
                                   segments_from_envelope)
        key = tuple(sorted(kw.items()))
        if not refresh and self._segments is not None \
                and self._segments[0] == key:
            return self._segments[1]
        sr = self.track.sample_rate
        wspan = WINDOW_GRANULES * self.spf
        hop = max(1, int(round(sr * kw.pop("hop_s", HOP_S))))
        env, res = [], np.zeros((0,), np.float32)
        pos = self._start
        while pos < self._end:
            w = pos // wspan
            pcm = self._window_pcm(w)
            if not len(pcm):
                break
            lo = pos - w * wspan
            hi = min(len(pcm), self._end - w * wspan)
            res = np.concatenate([res, sample_power(pcm[lo:hi])])
            F = len(res) // hop
            if F:
                env.append(env_db_from_power(res[: F * hop], hop))
                res = res[F * hop:]
            pos = min((w + 1) * wspan, self._end)
        env = np.concatenate(env) if env else np.zeros(0, np.float32)
        segs = segments_from_envelope(env, hop, sr,
                                      total=self._end - self._start, **kw)
        out = [(s / sr, e / sr) for s, e in segs]
        self._segments = (key, out)
        return out

    def play_segment(self, i: int, times: int = 1,
                     speed: float | None = None):
        """Replay sentence `i` (from segments()) `times` times, at an
        optional pitch-preserving speed."""
        segs = self.segments()
        if not 0 <= i < len(segs):
            raise IndexError(f"segment {i} of {len(segs)}")
        if speed is not None:
            self.set_speed(speed)
        a, b = segs[i]
        self.loop(a, b, times=times)

    def practice(self, times: int = 3, gap_s: float = 0.0,
                 speed: float | None = None, start: int = 0,
                 stop: int | None = None) -> list:
        """Sentence-by-sentence study session: each detected sentence in
        [start, stop) is replayed `times` times at the pitch-preserving
        `speed`, with `gap_s` seconds of silence after every repetition. A
        stop() from a sink callback ends the session between repetitions.
        Returns the practiced [(start_s, end_s), ...]."""
        segs = self.segments()
        lo = max(0, start)
        hi = len(segs) if stop is None else min(stop, len(segs))
        if speed is not None:
            self.set_speed(speed)
        gap = int(round(gap_s * self.track.sample_rate))
        nch = self.track.channels
        for a, b in segs[lo:hi]:
            for _ in range(times):
                self.loop(a, b, times=1)
                if gap:
                    self._push_i16(np.zeros((gap, nch), np.int16))
                if self.stopped:
                    return segs[lo:hi]
        return segs[lo:hi]

    def stop(self):
        self.stopped = True

    def pause(self):  # the cursor stops advancing; resume with play()
        self.stopped = True

    @property
    def speed(self) -> float:
        """Effective playback tempo (pitch-preserving; 1.0 = off)."""
        return self._speed

    def set_speed(self, speed: float):
        """Pitch-preserving tempo change, from the next processed chunk; a
        mid-play change keeps the vocoder's carried state, so the tempo
        glides without a click. speed == 1.0 returns to the direct emit
        path."""
        from ..dsp.timestretch import TimeStretch
        if speed != 1.0:
            if self._stretch is None:
                self._stretch = TimeStretch(self.track.channels, speed,
                                            device=self.device)
            else:
                self._stretch.set_speed(speed)
            if self._stretch.speed != 1.0:
                self._speed = self._stretch.speed
                return
            # the request quantized to unity: disengage
        if self._stretch is not None:
            tail = self._stretch.flush()
            if len(tail):
                self._pending.append(tail)
                self._pending_n += len(tail)
            self._stretch = None
            self._flush_pending()  # the tail reaches the sink now
        self._speed = 1.0

    # ------------------------------------------------- checkpoint/resume
    def snapshot(self) -> bytes:
        """Serialize the session cursor + DSP and decoder state (~KBs), in
        the JAX package's npz layout."""
        buf = io.BytesIO()
        state = self._state or kp.init_state(1, device=self.device)
        extra = {}
        if self._stretch is not None:
            extra = {f"ts_{k}": np.asarray(v)
                     for k, v in self._stretch.state_blob().items()}
        np.savez(buf, pos=self._pos,
                 state_granule=(-1 if self._state_granule is None
                                else self._state_granule),
                 overlap=state["overlap"].cpu().numpy(),
                 hist=state["hist"].cpu().numpy(),
                 eq_state=(self._eq_state.cpu().numpy()
                           if self._eq_state is not None else np.zeros(0)),
                 gain_db=self.gain_db, speed=self._speed, **extra)
        return buf.getvalue()

    def restore(self, blob: bytes):
        """Resume from snapshot() of this package's Player or the JAX
        package's."""
        z = np.load(io.BytesIO(blob))
        self._pos = int(z["pos"])
        sg = int(z["state_granule"])
        self._state_granule = None if sg < 0 else sg
        self._state = state_from_numpy(
            {"overlap": z["overlap"], "hist": z["hist"]}, self.device)
        if z["eq_state"].size and self._eq is not None:
            self._eq_state = state_from_numpy(z["eq_state"], self.device)
        else:
            # the snapshot carried no EQ tail: a stale one from playback
            # since the snapshot would corrupt the continuation
            self._eq_state = None
        # restore is discontinuous, like seek(): drop queued PCM
        self._pending = []
        self._pending_n = 0
        self.gain_db = float(z["gain_db"])
        self._applied_gain_db = self.gain_db
        self._speed = float(z["speed"]) if "speed" in z.files else 1.0
        self._stretch = None
        if "ts_ha" in z.files:
            from ..dsp.timestretch import TimeStretch
            self._stretch = TimeStretch(self.track.channels, self._speed,
                                        device=self.device)
            self._stretch.restore_blob(
                {k[3:]: z[k] for k in z.files if k.startswith("ts_")})
        elif self._speed != 1.0:
            self.set_speed(self._speed)
