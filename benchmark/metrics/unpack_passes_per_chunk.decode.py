"""Unpack passes a chunk: calls of mp3tpu_torch.pipeline._unpack_chunk (one
try at one plane width) over calls of unpack_planes. 1 where the 4-bit
planes with byte exponents hold the chunk; each widening adds one."""
from mp3bench.readers import PIPELINE


def instrument(probe):
    probe.time("unpack", PIPELINE, "unpack_planes", items_arg=0)
    probe.count("unpack_pass", PIPELINE, "_unpack_chunk")


def read(ctx):
    chunks = len(ctx.probe.spans.get("unpack", ()))
    passes = ctx.probe.counts.get("unpack_pass", 0)
    return passes / chunks if chunks else None
