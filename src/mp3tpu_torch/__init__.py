"""mp3tpu_torch — the batched MP3 decode and the player of mp3tpu in
PyTorch, with its TPU kernels rewritten in CUDA C++ for NVIDIA Hopper
(sm_90a).

The host half (container parse, C++ unpack, tables, fault counters, config)
is the port's own copy of mp3tpu's: this package imports torch, never jax
and nothing of mp3tpu.
"""
from .api import (decode, decode_batch, global_metrics, init, levels,  # noqa: F401
                  levels_batch, loudness, play, segment, segment_batch, split)


def __getattr__(name):
    # lazy: pipeline imports torch and the kernels' modules
    if name == "DecodedBatch":
        from .pipeline import DecodedBatch
        return DecodedBatch
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
