"""Device mesh and stream-axis sharding (counterpart of
mp3tpu.parallel.mesh).

MP3 streams are independent of each other, so the multi-device strategy is
data parallelism over the stream axis of a 1-D mesh: every [S, ...] array is
cut into contiguous slices, one per shard, each shard's pipeline runs on its
own device, and only metrics and the final gather cross devices. There is no
collective in the steady state.

Where the JAX package hands a sharded array to one jitted program, the port
holds a list with one entry per shard: shard_batch() makes it, the caller
(or sharded_decode_step()) runs the same function on each entry, unshard()
puts the results back in stream order.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class StreamMesh:
    """An ordered tuple of devices, one per shard, over the axis "streams".
    A device may appear more than once: several shards then share it (eight
    shards on the CPU, or two on one card, run as eight or two devices
    would, one after the other)."""
    devices: tuple
    axis_name: str = "streams"

    @property
    def size(self) -> int:
        return len(self.devices)


def make_stream_mesh(n_devices: int | None = None, device="cuda") -> StreamMesh:
    """On "cuda": the first n_devices cards (all of them if None), ValueError
    if there are fewer. On "cpu": n_devices shards (one if None), all on the
    CPU."""
    kind = torch.device(device).type
    if kind == "cpu":
        return StreamMesh((torch.device("cpu"),) * (1 if n_devices is None
                                                    else int(n_devices)))
    if kind != "cuda":
        raise ValueError(f"a stream mesh lies on cuda or cpu, not {device}")
    have = torch.cuda.device_count()
    n = have if n_devices is None else int(n_devices)
    if have < n or n < 1:
        raise ValueError(f"need {max(n, 1)} devices, have {have} (hint: "
                         f"make_stream_mesh({n}, device=\"cpu\") makes "
                         f"{n} shards on the CPU)")
    return StreamMesh(tuple(torch.device("cuda", i) for i in range(n)))


@dataclass(frozen=True)
class StreamSharding:
    """The rule that cuts a stream axis over a mesh: contiguous slices in
    stream order, balanced (the first S mod size shards hold one stream
    more); with fewer streams than shards the last shards are empty."""
    mesh: StreamMesh

    def slices(self, n_streams: int) -> list:
        return [shard_slice(n_streams, self.mesh.size, i)
                for i in range(self.mesh.size)]


def shard_slice(n_streams: int, size: int, index: int) -> slice:
    """Shard `index` of `size` over n_streams streams (StreamSharding's rule;
    a rank of a process group cuts by the same)."""
    q, r = divmod(n_streams, size)
    lo = index * q + min(index, r)
    return slice(lo, lo + q + (index < r))


def stream_sharding(mesh: StreamMesh) -> StreamSharding:
    return StreamSharding(mesh)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def shard_batch(mesh: StreamMesh, arrays, axis: int = 0) -> list:
    """Cut every array of `arrays` (a tuple, list or dict, nested at will, of
    tensors or numpy arrays whose dim `axis` is the stream axis) by
    stream_sharding(mesh). Returns one entry per shard: the same structure,
    holding that shard's slice as a tensor on that shard's device. axis=1
    serves window-major planes [n_win, S, ...]."""
    leaves = _leaves(arrays)
    if not leaves:
        raise ValueError("shard_batch: nothing to shard")
    n = {int(a.shape[axis]) for a in leaves}
    if len(n) != 1:
        raise ValueError(f"shard_batch: stream axes of different lengths {sorted(n)}")
    out = []
    for dev, sl in zip(mesh.devices, stream_sharding(mesh).slices(n.pop())):
        index = (slice(None),) * axis + (sl,)
        out.append(_tree_map(lambda a: torch.as_tensor(a[index]).to(dev), arrays))
    return out


def unshard(parts: list, axis: int = 0, device=None):
    """Inverse of shard_batch: the shards' structures joined leaf by leaf
    along `axis`, in shard order (so in stream order), on `device` (default:
    the first shard's device). Numpy leaves are joined with numpy; None
    entries (shards that held no stream and were not run) are skipped."""
    parts = [p for p in parts if p is not None]
    if not parts:
        raise ValueError("unshard: no shard to join")
    first = parts[0]
    if isinstance(first, dict):
        return {k: unshard([p[k] for p in parts], axis, device) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(unshard([p[i] for p in parts], axis, device)
                           for i in range(len(first)))
    if isinstance(first, np.ndarray):
        return np.concatenate(parts, axis=axis)
    dev = first.device if device is None else torch.device(device)
    return torch.cat([p.to(dev) for p in parts], dim=axis)


def sharded_decode_step(mesh: StreamMesh, fn, batch, states, *args,
                        axis: int = 0, **kw):
    """One decode step, sharded over the mesh: fn(*batch, *states, *args,
    **kw) on each shard's slice of `batch` (cut along `axis`) and of `states`
    (cut along 0), on that shard's device, the host starting the shards in
    turn; the results (every output's dim 0 is the stream axis) come back
    joined in stream order on the first shard's device. Shards that hold no
    stream are not run.

        sharded_decode_step(mesh, kp.decode_window_i16, symbols, (state,), sr)
    """
    b_parts = shard_batch(mesh, tuple(batch), axis=axis)
    s_parts = shard_batch(mesh, tuple(states), axis=0)
    outs = []
    for dev, b, s in zip(mesh.devices, b_parts, s_parts):
        if _leaves(s)[0].shape[0] == 0:
            outs.append(None)
            continue
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            outs.append(fn(*b, *s, *args, **kw))
    return unshard(outs, axis=0)
