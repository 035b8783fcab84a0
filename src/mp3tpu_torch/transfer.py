"""Device -> host copies started ahead of their use (the port's counterpart
of the JAX package's copy_to_host_async)."""
from __future__ import annotations

import numpy as np
import torch


class HostCopy:
    """A copy of `t` to the host, started when the object is made: for a
    CUDA tensor a non-blocking copy into fresh pinned memory on the current
    stream, with an event behind it; a CPU tensor is taken as it is.
    .numpy() waits for the copy and returns the host array, in pageable
    memory: sinks keep what they are pushed, and pinned memory held there
    would never go back to the allocator."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._host = t

    def numpy(self) -> np.ndarray:
        if self._event is None:
            return self._host.numpy()
        self._event.synchronize()
        return self._host.numpy().copy()
