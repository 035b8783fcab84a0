"""Tracing and profiling hooks (counterpart of mp3tpu.utils.profiling).

Device side: torch.profiler traces (Chrome trace JSON, readable in Perfetto
or chrome://tracing) and named ranges. All of them do nothing, or next to
nothing, when no trace is on, so they stay in the decode paths.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


def _cuda_live() -> bool:
    """A CUDA context exists in this process: some tensor went to the card."""
    return torch.cuda.is_available() and torch.cuda.is_initialized()


@contextlib.contextmanager
def device_trace(logdir: str | None = None):
    """A torch.profiler trace (host, and the card where there is one) around
    a region, written as one Chrome trace file into `logdir` or
    MP3TPU_TRACE_DIR; a no-op when neither is set."""
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
    prof.export_chrome_trace(os.path.join(
        logdir, f"mp3tpu_torch.{os.getpid()}.{time.time_ns()}.trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named range around a region: a torch.profiler.record_function span
    (it shows in device_trace's timeline) and, once the process uses the
    card, an NVTX range for external profilers."""
    nvtx = _cuda_live()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def fenced(fn, *args, **kw):
    """fn(*args, **kw), returned once the card has finished everything
    queued: host clocks around it then time the device's work too."""
    out = fn(*args, **kw)
    if _cuda_live():
        torch.cuda.synchronize()
    return out
