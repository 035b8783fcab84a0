"""decode_files (mp3tpu_torch.decode_batch, output="pcm") of whole songs
composed from the configuration's corpus: each stream joins between
song_parts[0] and song_parts[1] clips, so that every chunk's estimate
passes decode.batch_max_mb and the batch goes to the scheduler
(player.scheduler.decode_batch_streams). Only prepare is this module's
own: the call, what it completed, what is kept and the check are
decode_files's."""
from __future__ import annotations

import numpy as np

from .. import compose, faults
from .decode_files import (Batch, Work, call, check, completed,  # noqa: F401
                           control, keep)

# the faults that replace the entry's call replace decode_batch here too
faults.ENTRY_ATTR.setdefault("decode_songs", "decode_batch")


def song_plan(n_streams: int, lo: int, hi: int, n_clips: int, gen) -> list:
    """[n_streams][lo..hi] clip indices: the streams' lengths in parts are a
    permutation of the multiset {lo, ..., hi} taken n_streams / (hi-lo+1)
    times, and every clip is used equally often, both in an order from
    `gen`. Two seeds give the same lengths and the same clips, in other
    orders."""
    span = hi - lo + 1
    if n_streams % span:
        raise ValueError(f"{n_streams} streams do not take the lengths "
                         f"{lo}..{hi} equally often")
    lengths = gen.permutation(np.tile(np.arange(lo, hi + 1),
                                      n_streams // span))
    slots = int(lengths.sum())
    if slots % n_clips:
        raise ValueError(f"{slots} parts do not use {n_clips} clips "
                         "equally often")
    order = gen.permutation(np.repeat(np.arange(n_clips), slots // n_clips))
    return [p.tolist() for p in np.split(order, np.cumsum(lengths)[:-1])]


def prepare(cell, seed: int) -> Work:
    t = cell.traffic
    clips = compose.load_corpus(cell.config, cell.root)
    lo, hi = t["song_parts"]
    batches = []
    for b in range(t["distinct_batches"]):
        plan = song_plan(t["streams_per_call"], lo, hi, len(clips),
                         compose.rng(seed, 2, b))
        batches.append(Batch(inputs=[compose.compose([clips[i] for i in p])
                                     for p in plan], plan=plan))
    return Work(batches=batches, clips=clips)
