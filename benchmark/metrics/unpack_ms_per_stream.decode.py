"""Milliseconds of the host unpack a stream: the harness's timer around
mp3tpu_torch.pipeline.unpack_planes (the C++ unpacker on its threads into
fresh planes, every widening retry included), over the streams it took."""
from mp3bench.readers import PIPELINE


def instrument(probe):
    probe.time("unpack", PIPELINE, "unpack_planes", items_arg=0)


def read(ctx):
    s, n = ctx.probe.spans.get("unpack"), ctx.probe.items.get("unpack")
    return 1e3 * ctx.probe.total(s) / n if s and n else None
