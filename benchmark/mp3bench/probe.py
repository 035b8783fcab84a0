"""Spans and counters from outside the program, for the traced run only.

A per-layer metric's reader may define instrument(probe) and ask here for
what it reads: a timer around a function of the program (probe.time), a
count of its calls (probe.count), a process environment variable that
turns on one of the program's own telemetry switches (probe.env), or a
module attribute read after every call of the cell (probe.snapshot). The
wrappers replace the module attribute, which is where the program's own
callers look the function up; a request made twice (two metrics reading
one span) installs one wrapper; probe.restore() puts everything back.
Spans are held in memory, each as (start, end) on the host's clock; a
timer is also a "bench.<key>" range in a torch.profiler trace.
"""
from __future__ import annotations

import copy
import functools
import importlib
import os
import time
from collections import defaultdict

import torch


class Probe:
    def __init__(self):
        self.spans = defaultdict(list)      # key -> [(t0, t1)]
        self.counts = defaultdict(int)      # key -> calls
        self.items = defaultdict(int)       # key -> summed len(first arg)
        self.snapshots = defaultdict(list)  # key -> [value after each call]
        self._undo = []
        self._done = set()
        self._snap = {}
        self.armed = False                  # record only inside the window

    def _wrap(self, request: tuple, module: str, attr: str, make):
        if request in self._done:
            return
        self._done.add(request)
        mod = importlib.import_module(module)
        orig = getattr(mod, attr)
        setattr(mod, attr, make(orig))
        self._undo.append((mod, attr, orig))

    def time(self, key: str, module: str, attr: str, items_arg: int | None = None):
        """Time every call of module.attr under `key`; with items_arg, also
        sum len() of that positional argument (streams per call)."""
        def make(orig):
            @functools.wraps(orig)
            def timed(*a, **kw):
                t0 = time.perf_counter()
                try:
                    with torch.profiler.record_function("bench." + key):
                        return orig(*a, **kw)
                finally:
                    if self.armed:
                        self.spans[key].append((t0, time.perf_counter()))
                        if items_arg is not None:
                            self.items[key] += len(a[items_arg])
            return timed
        self._wrap(("time", key), module, attr, make)

    def count(self, key: str, module: str, attr: str):
        """Count the calls of module.attr under `key`."""
        def make(orig):
            @functools.wraps(orig)
            def counted(*a, **kw):
                if self.armed:
                    self.counts[key] += 1
                return orig(*a, **kw)
            return counted
        self._wrap(("count", key), module, attr, make)

    def env(self, name: str, value: str):
        """Set an environment variable for the rest of the run."""
        self._undo.append((os.environ, name, os.environ.get(name)))
        os.environ[name] = value

    def snapshot(self, key: str, module: str, attr: str, reset=None):
        """Copy module.attr after every call of the window into
        snapshots[key]; reset(value), when given, runs as the window
        opens."""
        self._snap[key] = (module, attr, reset)

    def open_window(self):
        for module, attr, reset in self._snap.values():
            if reset is not None:
                reset(getattr(importlib.import_module(module), attr))
        self.armed = True

    def after_call(self):
        if not self.armed:
            return
        for key, (module, attr, _r) in self._snap.items():
            self.snapshots[key].append(copy.deepcopy(
                getattr(importlib.import_module(module), attr)))

    def close_window(self):
        self.armed = False

    def restore(self):
        for owner, attr, orig in reversed(self._undo):
            if owner is os.environ:
                if orig is None:
                    os.environ.pop(attr, None)
                else:
                    os.environ[attr] = orig
            else:
                setattr(owner, attr, orig)
        self._undo.clear()

    @staticmethod
    def total(spans) -> float:
        return sum(t1 - t0 for t0, t1 in spans)
