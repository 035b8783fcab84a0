"""Multi-process bring-up on torch.distributed (counterpart of
mp3tpu.parallel.distributed).

The steady-state decode and encode need no collective: streams are
independent, and each rank works on its own contiguous slice of them
(rank_slice). This module covers the three places where ranks talk:
  (a) start-up (init_distributed; NCCL for ranks that each own a card, gloo
      for ranks on the CPU or ranks that share a card),
  (b) the final gather of the results (gather_to_host0),
  (c) the reduction of an aggregate metric (allreduce_metric, reduce_shards).
With no process group standing, each function is the identity of one rank.
"""
from __future__ import annotations

import datetime

import numpy as np
import torch

from .mesh import shard_slice

_REDUCE = {"sum": torch.sum, "max": torch.amax, "min": torch.amin}
# how long a rank waits for the others, at start-up and in a collective
TIMEOUT_S = 300.0


def _group():
    """torch.distributed if a process group stands, else None."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist
    return None


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, device="cuda",
                     backend: str | None = None) -> int:
    """Join the process group of a multi-process run; no-op for one process.

    coordinator is "host:port" of rank 0 (the group meets at
    tcp://host:port). The backend is NCCL when `device` is a card and gloo
    when it is the CPU, unless `backend` names one (ranks that share one
    card take gloo: NCCL wants a card per rank). Returns this process's rank.
    Safe to call unconditionally: with no coordinator and a single process
    it does nothing and returns 0."""
    if coordinator is None and num_processes in (None, 1):
        return 0
    if coordinator is None:
        raise ValueError(f"init_distributed: {num_processes} processes need "
                         "a coordinator (host:port of rank 0)")
    import torch.distributed as dist
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    world = 1 if num_processes is None else int(num_processes)
    rank = 0 if process_id is None else int(process_id)
    if not 0 <= rank < world:
        raise ValueError(f"init_distributed: process_id {rank} outside "
                         f"0..{world - 1}")
    if backend == "nccl" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return dist.get_rank()


def shutdown_distributed() -> None:
    """Leave the process group, if one stands."""
    dist = _group()
    if dist is not None:
        dist.destroy_process_group()


def rank_slice(n_streams: int) -> slice:
    """This rank's contiguous slice of n_streams streams, by the rule of
    mesh.stream_sharding (all of them when no process group stands)."""
    dist = _group()
    if dist is None:
        return slice(0, n_streams)
    return shard_slice(n_streams, dist.get_world_size(), dist.get_rank())


def _comm_device(dist) -> torch.device:
    """Where a collective's tensors must lie: the current card under NCCL,
    the host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def gather_to_host0(x):
    """Gather every rank's stream-sharded result, joined along dim 0 in rank
    order (the final PCM or MP3 collection). x is a numpy array, a tensor or
    a list (of bytes, say); the ranks' shards may differ in length. Every
    rank gets the whole, as with an all-gather. With no process group it
    returns x."""
    dist = _group()
    if dist is None:
        return x
    world = dist.get_world_size()
    if isinstance(x, (list, tuple)):
        got = [None] * world
        dist.all_gather_object(got, list(x))
        return [item for part in got for item in part]
    is_numpy = isinstance(x, np.ndarray)
    t = torch.from_numpy(np.ascontiguousarray(x)) if is_numpy else x.contiguous()
    metas = [None] * world
    dist.all_gather_object(metas, (tuple(t.shape), str(t.dtype)))
    if len({(m[0][1:], m[1]) for m in metas}) != 1:
        raise ValueError(f"gather_to_host0: shards disagree beyond dim 0: {metas}")
    # as bytes: NCCL moves no int16, and shards of unequal length are padded
    # to the longest
    comm = _comm_device(dist)
    raw = t.reshape(-1).view(torch.uint8).to(comm)
    item = t.element_size() * int(np.prod(t.shape[1:], dtype=np.int64))
    longest = max(m[0][0] for m in metas) * item
    send = torch.zeros(longest, dtype=torch.uint8, device=comm)
    send[: raw.numel()] = raw
    recv = [torch.empty_like(send) for _ in range(world)]
    dist.all_gather(recv, send)
    parts = [r[: m[0][0] * item].view(t.dtype).reshape(m[0])
             for r, m in zip(recv, metas)]
    whole = torch.cat(parts, dim=0)
    return whole.cpu().numpy() if is_numpy else whole.to(t.device)


def reduce_shards(parts, op: str = "sum") -> float:
    """Reduce one scalar per shard (tensors, each on its shard's device) to
    one float: the shards' values are brought to the first shard's device and
    reduced there in float32; when a process group stands, the result is then
    all-reduced over the ranks with the same op."""
    if op not in _REDUCE:
        raise ValueError(f"reduce_shards: op {op!r}, expected one of {sorted(_REDUCE)}")
    parts = [torch.as_tensor(p, dtype=torch.float32).reshape(()) for p in parts]
    dev = parts[0].device
    total = _REDUCE[op](torch.stack([p.to(dev) for p in parts]))
    dist = _group()
    if dist is not None:
        total = total.reshape(1).to(_comm_device(dist))
        dist.all_reduce(total, op={"sum": dist.ReduceOp.SUM,
                                   "max": dist.ReduceOp.MAX,
                                   "min": dist.ReduceOp.MIN}[op])
    return float(total)


def allreduce_metric(value: float, mesh=None) -> float:
    """Aggregate a scalar metric (a realtime factor, say) over the members:
    each contributes value / size in float32, placed on its own device, and
    the sum comes back. The members are the ranks when a process group
    stands, else the shards of `mesh` (one member with no mesh)."""
    dist = _group()
    if dist is not None:
        size, devices = dist.get_world_size(), [_comm_device(dist)]
    elif mesh is not None:
        size, devices = mesh.size, list(mesh.devices)
    else:
        size, devices = 1, [torch.device("cpu")]
    return reduce_shards([torch.full((), value / size, dtype=torch.float32,
                                     device=d) for d in devices], "sum")
