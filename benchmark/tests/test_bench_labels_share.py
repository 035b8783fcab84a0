"""encode.labels_device_share.encode, the share of encode_batch's streams
labelled from the device's energies: its reader on hand-made span totals,
its None cases, and a traced run of the encode cell on the CPU in which it
reads 100."""
import os
from types import SimpleNamespace

import pytest

from mp3bench import spec

NAME = "encode.labels_device_share.encode"


def tot(items, count=1):
    return {"count": count, "total_s": 0.01, "self_s": 0.01, "items": items}


def ctx_of(last=None, n_snaps=2):
    snaps = {} if last is None else {"spans": [{}] * (n_snaps - 1) + [last]}
    return SimpleNamespace(probe=SimpleNamespace(snapshots=snaps),
                           calls=[0.5, 0.5], trace=None)


@pytest.mark.parametrize("totals, want", [
    ({"mp3tpu.encode.labels/device": tot(128, 2)}, 100.0),
    ({"mp3tpu.encode.labels/host": tot(64)}, 0.0),
    ({"mp3tpu.encode.labels/device": tot(48, 3),
      "mp3tpu.encode.labels/host": tot(16)}, 75.0),
])
def test_the_reader_reads_the_window_totals(totals, want):
    r = spec.load_metric(NAME)
    assert r.read(ctx_of(dict(totals, **{"mp3tpu.encode.stage": tot(0)})))\
        == pytest.approx(want)


def test_the_reader_finds_nothing_without_the_span():
    r = spec.load_metric(NAME)
    assert r.read(ctx_of(None)) is None                  # nothing snapshot
    assert r.read(ctx_of({})) is None                    # no span opened
    assert r.read(ctx_of({"mp3tpu.encode.stage": tot(64)})) is None
    assert r.read(ctx_of({"mp3tpu.encode.labels/device": tot(0)})) is None


def test_a_traced_encode_run_reads_every_stream_on_the_device(small):
    """A whole traced run of cbr128.upload_encode at a test size on the CPU:
    the cell's int16-origin uploads are all labelled from device energies."""
    from mp3bench import main
    cell = small("cbr128.upload_encode")
    assert NAME in [m["name"] for m in cell.per_layer]
    r = main.measure(cell, 2 ** 31 + 29, 0.3, True, 0.0, device="cpu",
                     log=lambda s: None)
    assert r["correct"]
    assert r["metrics"][NAME]["value"] == 100.0
    assert "MP3TPU_SPANS" not in os.environ
