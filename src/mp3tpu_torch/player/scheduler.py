"""Stream scheduler: batches many live streams into fixed-shape device steps
(counterpart of mp3tpu.player.scheduler).

S slots, each holding one stream's symbols and a granule cursor. Every step
gathers the next `win` granules of all slots into one [S, win, ...] batch
(finished or empty slots padded with zero granules, which decode to
silence), runs one decode_window_i16 with the per-slot decoder state, and
routes each slot's PCM to its sink. Finished slots are refilled from the
queue with their state rows reset.

run() keeps one step in flight: the host packs window w+1 while the device
decodes window w. Each step's int16 PCM is copied to pinned host memory as
soon as the step is enqueued, so routing window w waits for window w's
copy and not for window w+1's decode. The host arrays of a step are fresh
for every step, so nothing the device may still read is written again.

All streams in one scheduler share a sample rate.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..bitstream.unpack import SymbolTensors
from ..dsp.gapless import gapless_bounds
from ..kernels import pipeline as kp
from ..kernels.tables import state_from_numpy, state_to_numpy
from ..metrics import Metrics, record_resyncs, record_symbol_errors
from ..transfer import HostCopy
from .sink import CollectSink, Sink, take_underruns


@dataclass
class _Slot:
    symbols: object = None  # SymbolSource or SymbolTensors
    cursor: int = 0                      # next granule to decode
    sink: Sink | None = None
    total_emitted: int = 0
    end_sample: int | None = None        # gapless end bound
    start_skip: int = 0                  # gapless leading samples to drop
    active: bool = False
    stream_id: object = None


def info_bounds(info, n_granules: int) -> tuple[int, int | None]:
    """(start_skip, end_sample) from a parsed StreamInfo's LAME tag, or
    (0, None)."""
    if info.gapless:
        return gapless_bounds(n_granules * 576, info.encoder_delay,
                              info.encoder_padding)
    return 0, None


def gapless_bounds_of(data: bytes, n_granules: int) -> tuple[int, int | None]:
    """(start_skip, end_sample) from the stream's LAME tag, or (0, None).
    Scans the whole stream: where load_source's StreamInfo is at hand,
    info_bounds gives the same bounds without a second scan."""
    from ..container import frames as fr
    from ..container.xing import parse_stream_info
    try:
        idx = fr.scan_frames(np.frombuffer(data, np.uint8))
        info = parse_stream_info(bytes(data), int(idx.offsets[0]),
                                 idx.headers[0])
    except (ValueError, IndexError):  # no frame the container scan takes
        return 0, None
    return info_bounds(info, n_granules)


class StreamScheduler:
    """Masked-batch streaming decode engine over one device."""

    def __init__(self, n_slots: int | None = None, win: int | None = None,
                 sample_rate: int = 44100, device="cuda"):
        from ..config import get_active
        cfg = get_active().scheduler
        self.S = cfg.n_slots if n_slots is None else n_slots
        self.win = cfg.window_granules if win is None else win
        self.sample_rate = sample_rate
        self.device = torch.device(device)
        self.slots = [_Slot() for _ in range(self.S)]
        self.queue: list[tuple[object, SymbolTensors, Sink, int, int | None]] = []
        self.state = kp.init_state(self.S, device=self.device)
        self.metrics = Metrics()
        self.trace: list[tuple[str, int]] = []  # ("dispatch"/"route", seq)
        self._seq = 0

    # ------------------------------------------------------------ intake
    def submit(self, data_or_symbols, sink: Sink | None = None,
               stream_id=None, apply_gapless: bool = True,
               bounds: tuple[int, int | None] | None = None):
        """Queue one stream (mp3 bytes or pre-unpacked SymbolTensors).
        `bounds` overrides the gapless (start_skip, end_sample)."""
        info = None
        if isinstance(data_or_symbols, SymbolTensors):
            st = data_or_symbols
        else:
            # streaming source: container parse only; granule windows are
            # unpacked per step in _pack_dispatch
            from ..pipeline import load_source
            with self.metrics.span("host"):
                st, info, index = load_source(bytes(data_or_symbols))
            record_resyncs(index.resyncs, self.metrics)
        if st.sample_rate != self.sample_rate:
            raise ValueError(
                f"scheduler is bucketed at {self.sample_rate} Hz, stream is "
                f"{st.sample_rate} Hz — use one scheduler per sample rate")
        if bounds is not None:
            start_skip, end = bounds
        elif apply_gapless and info is not None:
            # load_source's parse: the JAX package scans the stream a
            # second time here, in gapless_bounds_of
            start_skip, end = info_bounds(info, st.n_granules)
        else:
            start_skip, end = 0, None
        self.queue.append((stream_id, st, sink or CollectSink(),
                           start_skip, end))
        self._refill()
        return self.queue and stream_id

    def _refill(self):
        fresh = []
        for i, slot in enumerate(self.slots):
            if slot.active or not self.queue:
                continue
            sid, st, sink, skip, end = self.queue.pop(0)
            self.slots[i] = _Slot(symbols=st, cursor=0, sink=sink,
                                  end_sample=end, start_skip=skip,
                                  active=True, stream_id=sid)
            fresh.append(i)
            self.metrics.streams_active += 1
        if fresh:
            # new state tensors with the fresh slots' rows zeroed: a step
            # in flight keeps reading the tensors it was given
            rows = torch.tensor(fresh, device=self.device)
            self.state = {k: v.index_fill(0, rows, 0.0)
                          for k, v in self.state.items()}

    @property
    def n_active(self) -> int:
        return sum(s.active for s in self.slots)

    @property
    def steps(self) -> int:
        """Windows dispatched so far: one device step (one launch of each
        kernel of decode_window_i16) each."""
        return self._seq

    # -------------------------------------------------------------- step
    def _pack_dispatch(self):
        """Pack and enqueue one window. Returns a routing plan (the PCM's
        host copy in flight + per-slot slices) or None when idle."""
        S, W = self.S, self.win
        self._refill()
        if self.n_active == 0:
            return None
        is_ = np.zeros((S, W, 2, 576), np.int16)
        exp = np.zeros((S, W, 2, 64), np.int16)
        bt = np.zeros((S, W, 2), np.int8)
        mx = np.zeros((S, W, 2), bool)
        sm = np.zeros((S, W, 64), np.uint8)
        entries = []  # (slot_idx, sink, channels, n, lo, hi)
        with self.metrics.span("host"):
            for i, slot in enumerate(self.slots):
                if not slot.active:
                    continue
                st = slot.symbols
                n = min(W, st.n_granules - slot.cursor)
                if n <= 0:
                    # a stream with no audio granules (a lone metadata
                    # frame) finishes here; the JAX package's scheduler
                    # keeps such a slot active and never drains
                    slot.active = False
                    self.metrics.streams_active -= 1
                    self.metrics.streams_finished += 1
                    continue
                ck = st.granules(slot.cursor, slot.cursor + n)
                # fault accounting: the flags of exactly the granules this
                # step decodes (the cursor only moves forward)
                record_symbol_errors(ck.errors, ck.granules_per_frame,
                                     self.metrics)
                is_[i, :n] = ck.is_
                exp[i, :n] = ck.exp
                bt[i, :n] = ck.block_type
                mx[i, :n] = ck.mixed
                sm[i, :n] = ck.smode
                # emission bounds depend on the cursor, never on the PCM
                pos0 = slot.cursor * 576
                lo = max(slot.start_skip - pos0, 0)
                hi = n * 576
                if slot.end_sample is not None:
                    hi = min(hi, slot.end_sample - pos0)
                entries.append((i, slot.sink, st.channels, n, lo, hi))
                slot.cursor += n
                slot.total_emitted += max(hi - lo, 0)
                self.metrics.granules_decoded += n
                done = slot.cursor >= st.n_granules or (
                    slot.end_sample is not None
                    and pos0 + hi >= slot.end_sample)
                if done:
                    slot.active = False
                    self.metrics.streams_active -= 1
                    self.metrics.streams_finished += 1
        dev = lambda a: torch.from_numpy(a).to(self.device)
        pcm16, self.state = kp.decode_window_i16(
            dev(is_), dev(exp), dev(bt), dev(mx), dev(sm), self.state,
            self.sample_rate)
        seq = self._seq
        self._seq += 1
        self.trace.append(("dispatch", seq))
        self._refill()
        return {"pcm": HostCopy(pcm16), "entries": entries, "seq": seq}

    def _materialize_route(self, plan) -> int:
        """Wait for the window's PCM on the host and route it to sinks."""
        with self.metrics.span("device"):
            pcm16 = plan["pcm"].numpy()
        self.trace.append(("route", plan["seq"]))
        emitted = 0
        for i, sink, channels, n, lo, hi in plan["entries"]:
            out = pcm16[i, : n * 576, :channels]
            if hi > lo:
                sink.push(out[lo:hi])
                emitted += hi - lo
            u = take_underruns(sink)
            if u:
                from ..metrics import record_underruns
                record_underruns(u, self.metrics)
        self.metrics.samples_out += emitted
        return emitted

    def step(self) -> int:
        """One batched device step; returns samples emitted (all slots)."""
        plan = self._pack_dispatch()
        return 0 if plan is None else self._materialize_route(plan)

    def run(self, max_steps: int | None = None,
            checkpoint_every: int | None = None,
            on_checkpoint=None) -> int:
        """Step until all queued streams drain, keeping one step in flight
        so host packing overlaps device compute.

        checkpoint_every=N calls on_checkpoint(self.snapshot()) after every
        N routed windows, at a window boundary with no step in flight."""
        total = 0
        steps = 0
        pending = self._pack_dispatch()
        while pending is not None:
            steps += 1
            take_ckpt = (checkpoint_every is not None
                         and on_checkpoint is not None
                         and steps % checkpoint_every == 0)
            nxt = None
            if (max_steps is None or steps < max_steps) and not take_ckpt:
                nxt = self._pack_dispatch()  # overlaps pending's compute
            total += self._materialize_route(pending)
            if take_ckpt:
                on_checkpoint(self.snapshot())
                if max_steps is None or steps < max_steps:
                    nxt = self._pack_dispatch()
            pending = nxt
        return total

    # ------------------------------------------------- checkpoint/resume
    def snapshot(self) -> dict:
        """Batch checkpoint, in the JAX package's format: per-slot
        progress, the decoder state rows and queued stream ids (no stream
        content: restore() takes a resolver). Taken at a window boundary
        (no step in flight)."""
        return {
            "version": 1,
            "sample_rate": self.sample_rate,
            "win": self.win,
            "S": self.S,
            "slots": [
                {"stream_id": s.stream_id, "cursor": s.cursor,
                 "total_emitted": s.total_emitted,
                 "end_sample": s.end_sample, "start_skip": s.start_skip,
                 "active": s.active}
                for s in self.slots
            ],
            "state": state_to_numpy(self.state),
            "queue": [
                {"stream_id": sid, "start_skip": skip, "end_sample": end}
                for sid, _st, _sink, skip, end in self.queue
            ],
        }

    def restore(self, snap: dict, resolve, sink_for=None) -> None:
        """Rebuild this scheduler from snapshot() (this package's or the
        JAX package's). `resolve(stream_id)` returns the stream's mp3 bytes
        or SymbolTensors; `sink_for` (optional) returns a fresh Sink per
        stream_id (default: CollectSink)."""
        from ..pipeline import load_source
        if snap.get("version") != 1:
            raise ValueError("unknown scheduler snapshot version")
        if (snap["S"], snap["win"], snap["sample_rate"]) != \
                (self.S, self.win, self.sample_rate):
            raise ValueError("snapshot shape/rate mismatch with scheduler")

        def _symbols(sid):
            data = resolve(sid)
            if isinstance(data, SymbolTensors) or hasattr(data, "granules"):
                return data
            return load_source(bytes(data))[0]

        self.slots = []
        for rec in snap["slots"]:
            slot = _Slot()
            if rec["active"]:
                slot = _Slot(symbols=_symbols(rec["stream_id"]),
                             cursor=rec["cursor"],
                             sink=(sink_for(rec["stream_id"]) if sink_for
                                   else CollectSink()),
                             total_emitted=rec["total_emitted"],
                             end_sample=rec["end_sample"],
                             start_skip=rec["start_skip"], active=True,
                             stream_id=rec["stream_id"])
            self.slots.append(slot)
        self.state = state_from_numpy(
            {k: np.asarray(v) for k, v in snap["state"].items()}, self.device)
        self.queue = [
            (q["stream_id"], _symbols(q["stream_id"]),
             sink_for(q["stream_id"]) if sink_for else CollectSink(),
             q["start_skip"], q["end_sample"])
            for q in snap["queue"]
        ]
        self.metrics.streams_active = sum(s.active for s in self.slots)


def decode_batch_streams(paths_or_bytes, n_slots: int = 64, win: int = 32,
                         gapless: bool = True, return_info: bool = False,
                         device="cuda"):
    """Batched decode through the scheduler: list of (pcm int16, sample_rate)
    aligned with the inputs, trimmed by each stream's LAME tag as the
    single-file decode trims. return_info=True returns (results,
    [StreamInfo])."""
    from ..pipeline import load_source
    datas = []
    for p in paths_or_bytes:
        if isinstance(p, (bytes, bytearray)):
            datas.append(bytes(p))
        else:
            with open(p, "rb") as f:
                datas.append(f.read())
    # load_source skips ID3 regions and a leading Xing/Info frame, as the
    # single-file decode does; the batch unpacks whole streams
    loaded = [load_source(d) for d in datas]
    infos = [info for _src, info, _index in loaded]
    # container resyncs are booked here: submit() books them only for
    # byte inputs
    for _src, _info, index in loaded:
        record_resyncs(index.resyncs)
    symbols = [src.whole() for src, _info, _index in loaded]
    rates = {st.sample_rate for st in symbols}
    out: list = [None] * len(datas)
    for rate in sorted(rates):
        idxs = [i for i, st in enumerate(symbols) if st.sample_rate == rate]
        sched = StreamScheduler(n_slots=min(n_slots, len(idxs)), win=win,
                                sample_rate=rate, device=device)
        sinks = {}
        for i in idxs:
            sinks[i] = CollectSink()
            # the bounds of load_source's parse (the JAX package scans each
            # stream a second time for them, in gapless_bounds_of)
            bounds = (info_bounds(infos[i], symbols[i].n_granules) if gapless
                      else (0, None))
            sched.submit(symbols[i], sink=sinks[i], stream_id=i,
                         bounds=bounds)
        sched.run()
        for i in idxs:
            out[i] = (sinks[i].pcm, rate)
    return (out, infos) if return_info else out
