"""Milliseconds of the container scan a stream: the harness's timer around
mp3tpu_torch.pipeline.stream_meta (ID3, the frame walk in Python, the
Xing/LAME frame), over the window's calls."""
from mp3bench.readers import PIPELINE


def instrument(probe):
    probe.time("scan", PIPELINE, "stream_meta")


def read(ctx):
    s = ctx.probe.spans.get("scan")
    return 1e3 * ctx.probe.total(s) / len(s) if s else None
