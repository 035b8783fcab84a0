"""Tracing and profiling hooks (counterpart of mp3tpu.utils.profiling).

Device side: torch.profiler traces (Chrome trace JSON, readable in Perfetto
or chrome://tracing) and named ranges. All of them do nothing, or next to
nothing, when no trace is on, so they stay in the decode paths.

Host side: spans kept in memory, for the program's own per-layer
metrics. Every `annotate` range is also a span while recording is on;
`request` opens the root span of one top-level call (decode_files,
encode_batch, transcode_batch) and reads the switch: recording is on
while MP3TPU_SPANS=1 or MP3TPU_TRACE_DIR is set. A span has a name (a fixed string; variable parts go into its attrs),
start and end on time.perf_counter_ns, its parent (a per-thread stack),
the request id of its root, `items` (streams, rows or bytes) and an
outcome it may set before it closes ("overflow", say; "error" when an
exception leaves it).

What is kept, all bounded and mutated in place (never rebound, so a reader
may hold and clear them):
  RING    the last 65,536 spans, raw;
  TOTALS  name, or name/outcome -> {"count", "total_s", "self_s", "items"}
          (self_s: the duration less what the span's children cover).
One anchor pair (perf_counter_ns, time_ns), taken when recording first
starts, maps the spans onto torch.profiler's timeline (Unix time less the
trace's baseTimeNanoseconds): chrome_events() gives them on it, and under
MP3TPU_TRACE_DIR the ring is written there at exit as
mp3tpu_torch.<pid>.spans.json, on the clock of the torch trace that
device_trace wrote last in the process.
"""
from __future__ import annotations

import atexit
import collections
import contextlib
import itertools
import json
import os
import re
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

RING_SPANS = 65536
RING: collections.deque = collections.deque(maxlen=RING_SPANS)
TOTALS: dict = {}

_ON = False                 # recording, as the last request root read it
_ANCHOR = None              # (perf_counter_ns, time_ns) when recording began
_BASE_NS = [0]              # baseTimeNanoseconds of device_trace's last trace
_AT_EXIT = []               # MP3TPU_TRACE_DIR's directory, once registered
_LOCK = threading.Lock()
_TLS = threading.local()    # .stack: this thread's open spans
_IDS = itertools.count(1)
_REQUESTS = itertools.count(1)


def _cuda_live() -> bool:
    """A CUDA context exists in this process: some tensor went to the card."""
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def _read_switch() -> None:
    global _ON, _ANCHOR
    logdir = os.environ.get("MP3TPU_TRACE_DIR")
    _ON = os.environ.get("MP3TPU_SPANS") == "1" or bool(logdir)
    if _ON and _ANCHOR is None:
        _ANCHOR = (time.perf_counter_ns(), time.time_ns())
    if logdir and not _AT_EXIT:
        _AT_EXIT.append(logdir)
        atexit.register(_write_at_exit)


def _stack() -> list:
    s = getattr(_TLS, "stack", None)
    if s is None:
        s = _TLS.stack = []
    return s


class annotate:
    """A named range around a region: a torch.profiler.record_function
    range while a profiler runs (it shows in device_trace's timeline, as
    name[v1:v2...] of the attrs' values), once the process uses the card an
    NVTX range for external profilers, and a span while recording is on.
    Used as `with annotate(name, items, **attrs) as sp:`; sp.outcome and
    sp.items may be set inside."""
    __slots__ = ("name", "items", "attrs", "outcome", "_rf", "_nvtx", "_rec",
                 "_t0", "_child", "_id", "_parent", "_rid")

    def __init__(self, name: str, items: int = 0, **attrs):
        self.name, self.items, self.attrs = name, items, attrs
        self.outcome = None

    def __enter__(self):
        self._rec = _ON
        if self._rec:
            stack = _stack()
            if stack:
                parent = stack[-1]
                self._parent, self._rid = parent._id, parent._rid
            else:
                self._parent, self._rid = 0, next(_REQUESTS)
            self._id = next(_IDS)
            self._child = 0
            stack.append(self)
            # stamped outside the ranges, so that the span holds them
            self._t0 = time.perf_counter_ns()
        self._nvtx = _cuda_live()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self._rf = None
        # a torch without the flag enters the range always
        if getattr(_autograd_profiler, "_is_profiler_enabled", True):
            label = self.name
            if self.attrs:
                label += "[" + ":".join(map(str, self.attrs.values())) + "]"
            self._rf = torch.profiler.record_function(label)
            self._rf.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._rf is not None:
            self._rf.__exit__(exc_type, exc, tb)
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        if self._rec:
            self._close(time.perf_counter_ns(), exc_type is not None)
        return False

    def _close(self, t1: int, failed: bool) -> None:
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        dur = t1 - self._t0
        if stack:
            stack[-1]._child += dur
        if failed and self.outcome is None:
            self.outcome = "error"
        key = (self.name if self.outcome is None
               else f"{self.name}/{self.outcome}")
        with _LOCK:
            RING.append((self.name, self._t0, t1, self._id, self._parent,
                         self._rid, self.items, self.outcome, self.attrs,
                         threading.get_native_id()))
            tot = TOTALS.get(key)
            if tot is None:
                tot = TOTALS[key] = {"count": 0, "total_s": 0.0,
                                     "self_s": 0.0, "items": 0}
            tot["count"] += 1
            tot["total_s"] += dur * 1e-9
            tot["self_s"] += (dur - self._child) * 1e-9
            tot["items"] += int(self.items)


class request(annotate):
    """annotate for a top-level call: where no span is open on the thread,
    it is a request's root and reads the switch first (MP3TPU_SPANS=1 or
    MP3TPU_TRACE_DIR turns recording on, else off); nested in a span, it
    is that span's child."""
    __slots__ = ()

    def __enter__(self):
        if not _stack():
            _read_switch()
        return annotate.__enter__(self)


def chrome_events(base_ns: int = 0) -> list:
    """The ring as Chrome-trace "X" events, ts in µs on the clock of a
    torch.profiler trace whose baseTimeNanoseconds is base_ns."""
    if _ANCHOR is None:
        return []
    p0, u0 = _ANCHOR
    pid = os.getpid()
    with _LOCK:
        ring = list(RING)
    out = []
    for name, t0, t1, sid, parent, rid, items, outcome, attrs, tid in ring:
        args = {"id": sid, "parent": parent, "request": rid, "items": items}
        if outcome is not None:
            args["outcome"] = outcome
        args.update(attrs)
        out.append({"ph": "X", "cat": "mp3tpu_span", "name": name,
                    "pid": pid, "tid": tid,
                    "ts": (u0 + (t0 - p0) - base_ns) / 1e3,
                    "dur": (t1 - t0) / 1e3, "args": args})
    return out


def _write_at_exit() -> None:
    """The ring as one Chrome trace file in MP3TPU_TRACE_DIR, on the clock
    of device_trace's last trace."""
    if not RING:
        return
    os.makedirs(_AT_EXIT[0], exist_ok=True)
    path = os.path.join(_AT_EXIT[0], f"mp3tpu_torch.{os.getpid()}.spans.json")
    with open(path, "w") as f:
        json.dump({"traceEvents": chrome_events(_BASE_NS[0]),
                   "baseTimeNanoseconds": _BASE_NS[0]}, f, default=str)


_BASE_RE = re.compile(rb'"baseTimeNanoseconds"\s*:\s*(\d+)')


def _trace_base_ns(path: str) -> int | None:
    """baseTimeNanoseconds of a torch.profiler Chrome trace, looked for in
    the file's first and last 64 KB."""
    with open(path, "rb") as f:
        head = f.read(1 << 16)
        f.seek(max(0, os.path.getsize(path) - (1 << 16)))
        tail = f.read()
    m = _BASE_RE.search(head) or _BASE_RE.search(tail)
    return int(m.group(1)) if m else None


@contextlib.contextmanager
def device_trace(logdir: str | None = None):
    """A torch.profiler trace (host, and the card where there is one) around
    a region, written as one Chrome trace file into `logdir` or
    MP3TPU_TRACE_DIR; a no-op when neither is set. Outside any span it
    reads the switch, as a request's root does, so that MP3TPU_TRACE_DIR
    records the spans under it too."""
    if not _stack():
        _read_switch()
    logdir = logdir or os.environ.get("MP3TPU_TRACE_DIR")
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    path = os.path.join(
        logdir, f"mp3tpu_torch.{os.getpid()}.{time.time_ns()}.trace.json")
    prof.export_chrome_trace(path)
    base = _trace_base_ns(path)
    if base is not None:
        _BASE_NS[0] = base
