"""Device -> host copies started ahead of their use (the port's counterpart
of the JAX package's copy_to_host_async)."""
from __future__ import annotations

import numpy as np
import torch

_COPY_STREAMS: dict = {}


def copy_stream(device: torch.device) -> torch.cuda.Stream:
    """The one side stream of `device` that overlapped D2H copies run on."""
    key = (device.type, torch.cuda.current_device()
           if device.index is None else device.index)
    if key not in _COPY_STREAMS:
        _COPY_STREAMS[key] = torch.cuda.Stream(device=device)
    return _COPY_STREAMS[key]


class HostCopy:
    """A copy of `t` to the host, started when the object is made: for a
    CUDA tensor a non-blocking copy into fresh pinned memory, with an event
    behind it; a CPU tensor is taken as it is.

    overlap=False queues the copy on the current stream, behind the work
    that made `t`. overlap=True queues it on the device's copy stream, which
    waits for an event recorded on the current stream now: the copy then runs
    beside whatever the current stream is given next (the next segment of a
    window loop). `t` is kept, and marked as in use by the copy stream, until
    the copy is done, so the caching allocator cannot hand its memory to a
    later kernel while the copy still reads it.

    .numpy() waits for the copy and returns the host array, in pageable
    memory: sinks keep what they are pushed, and pinned memory held there
    would never go back to the allocator. .numpy(owned=False) returns the
    pinned memory itself, for a caller that slices its own copies out of it
    and drops it."""

    def __init__(self, t: torch.Tensor, overlap: bool = False):
        self._event = None
        self._src = None
        if t.device.type != "cuda":
            self._host = t
            return
        self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        current = torch.cuda.current_stream(t.device)
        if not overlap:
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(current)
            return
        side = copy_stream(t.device)
        ready = torch.cuda.Event()
        ready.record(current)
        side.wait_event(ready)
        with torch.cuda.stream(side):
            self._host.copy_(t, non_blocking=True)
        t.record_stream(side)
        self._src = t
        self._event = torch.cuda.Event()
        self._event.record(side)

    def numpy(self, owned: bool = True) -> np.ndarray:
        if self._event is None:
            return self._host.numpy()
        self._event.synchronize()
        self._src = None
        host = self._host.numpy()
        return host.copy() if owned else host
