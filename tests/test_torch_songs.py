"""Whole songs through the scheduler on the CPU: decode_files hands streams
whose chunk estimate passes decode.batch_max_mb to
player.scheduler.decode_batch_streams. Composed VBR (vbr_v2) and CBR
(cbr128) streams of the benchmark's corpus, cut to a test size, come back
at their full gapless length and within the configuration's limits of the
benchmark's plain float64 reference (benchmark/mp3bench/reference); the
scheduler's spans (mp3tpu.sched.load, .unpack, .pack, .route) carry the
items they state, and none is kept while recording is off."""
import os
import sys

import numpy as np
import pytest
import torch

import mp3tpu_torch
from mp3tpu_torch import config as port_config
from mp3tpu_torch.player.scheduler import decode_batch_streams
from mp3tpu_torch.utils import profiling

torch.set_num_threads(1)  # one torch thread a pytest-xdist worker
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from mp3bench import compose, reference, spec  # noqa: E402
from mp3bench.checks import decode_numbers  # noqa: E402
from mp3bench.reference.container import frames as fr  # noqa: E402

FRAMES = 16     # a clip cut to 16 audio frames: 32 granules, one window
CHORD = 1       # the vbr_v2 clip whose frames change size from the first


def config(name):
    return spec.load_json(os.path.join(BENCH, "configs", f"{name}.json"))


def cut_clips(name, n_frames=FRAMES):
    """The configuration's corpus clips cut to their first n_frames audio
    frames."""
    out = []
    for c in compose.load_corpus(config(name), ROOT):
        idx = fr.scan_frames(np.frombuffer(c.audio, np.uint8))
        c.audio = c.audio[:int(idx.offsets[n_frames])]
        c.n_audio_frames = n_frames
        out.append(c)
    return out


def songs(name, plan):
    clips = cut_clips(name)
    return [compose.compose([clips[i] for i in p]) for p in plan]


VBR_PLAN = [[CHORD, 0, 2], [3, CHORD, 4], [5, 6, CHORD], [CHORD, 7, CHORD]]
CBR_PLAN = [[0, 1, 2], [5, 6, 7]]


@pytest.fixture
def to_scheduler():
    """A staging cap of 1 MB: every chunk's estimate passes it, so
    decode_files hands the whole batch to the scheduler."""
    port_config.set_active(port_config.resolve(decode={"batch_max_mb": 1}))
    yield
    port_config.set_active(port_config.resolve())


def clear():
    for d in (profiling.TOTALS, profiling.RING):
        d.clear()


@pytest.fixture
def spans_on(monkeypatch):
    monkeypatch.delenv("MP3TPU_TRACE_DIR", raising=False)
    monkeypatch.setenv("MP3TPU_SPANS", "1")
    clear()
    yield
    monkeypatch.delenv("MP3TPU_SPANS")
    with profiling.request("mp3tpu.test_off"):  # reads the switch: off
        pass
    clear()


def ring(name):
    keys = ("name", "t0", "t1", "id", "parent", "request", "items",
            "outcome", "attrs", "thread")
    return [dict(zip(keys, r)) for r in profiling.RING if r[0] == name]


@pytest.mark.parametrize("name, plan", [("vbr_v2", VBR_PLAN),
                                        ("cbr128", CBR_PLAN)])
def test_songs_through_the_scheduler_match_the_reference(
        name, plan, to_scheduler, spans_on):
    datas = songs(name, plan)
    if name == "vbr_v2":
        sizes = {h.frame_bytes for d in datas
                 for h in fr.scan_frames(np.frombuffer(d, np.uint8)).headers}
        assert len(sizes) >= 3          # frames of changing size
    got = mp3tpu_torch.decode_batch(datas, device="cpu", output="pcm")
    # every stream went through the scheduler's intake
    assert profiling.TOTALS["mp3tpu.sched.load"]["count"] == len(datas)
    cfg = config(name)
    pairs = []
    for data, p, out in zip(datas, plan, got):
        want, rate = reference.decode(data)
        clips = cut_clips(name)
        full = (len(p) * FRAMES * 1152 - clips[p[0]].delay
                - clips[p[-1]].padding)
        assert out[1] == rate == 44100 and out[0].shape == (full, 2)
        pairs.append((out, want, rate))
    n = decode_numbers(pairs)
    assert n["streams_off"] == 0
    assert n["max_lsb"] <= cfg["limits"]["max_lsb"]
    assert n["inexact_pct"] <= cfg["limits"]["inexact_pct"]


def test_the_scheduler_spans_carry_their_items(to_scheduler, spans_on):
    datas = songs("vbr_v2", VBR_PLAN[:2] + [[CHORD]])
    mp3tpu_torch.decode_batch(datas, device="cpu", output="pcm")
    [root] = ring("mp3tpu.decode_files")
    [sched_root] = ring("mp3tpu.decode_batch_streams")
    assert sched_root["parent"] == root["id"] and sched_root["items"] == 3
    loads, unpacks = ring("mp3tpu.sched.load"), ring("mp3tpu.sched.unpack")
    assert [s["items"] for s in loads] == [1, 1, 1]
    # granules of each whole stream (2 a frame, the Xing frame left out),
    # in the fast path's order, shortest first
    assert [s["items"] for s in unpacks] == [32, 96, 96]
    for s in loads + unpacks:
        assert s["parent"] == sched_root["id"]
    packs, routes = ring("mp3tpu.sched.pack"), ring("mp3tpu.sched.route")
    # 3 steps of 32 granules, then the pack that finds every slot idle
    assert [s["items"] for s in packs] == [3, 2, 2, 0]
    assert [s["items"] for s in routes] == [3, 3, 3]
    assert all(s["attrs"] == {"n_slots": 3} for s in packs + routes)
    t = profiling.TOTALS
    assert t["mp3tpu.sched.pack"]["items"] == 7
    assert t["mp3tpu.sched.route"]["items"] == 9


def test_decode_batch_streams_called_directly_is_a_root(spans_on):
    datas = songs("cbr128", [[0], [1, 2]])
    out = decode_batch_streams(datas, device="cpu")
    assert [len(o[0]) > 0 for o in out] == [True, True]
    [root] = ring("mp3tpu.decode_batch_streams")
    assert root["parent"] == 0 and root["items"] == 2
    assert {r[5] for r in profiling.RING} == {root["request"]}
    assert "mp3tpu.decode_files" not in profiling.TOTALS


def test_recording_off_keeps_no_scheduler_span(to_scheduler, monkeypatch):
    monkeypatch.delenv("MP3TPU_SPANS", raising=False)
    monkeypatch.delenv("MP3TPU_TRACE_DIR", raising=False)
    clear()
    mp3tpu_torch.decode_batch(songs("cbr128", CBR_PLAN), device="cpu",
                              output="pcm")
    decode_batch_streams(songs("vbr_v2", [[CHORD]]), device="cpu")
    assert len(profiling.RING) == 0 and profiling.TOTALS == {}


@pytest.mark.parametrize("clip", ["sweep", "piano"])
def test_bits_that_end_where_a_table_0_region_starts_are_no_overrun(
        clip, to_scheduler):
    """Big values whose last region selects table 0 take no bits there, so
    a granule whose part2_3 bits end where that region starts has not
    overrun. One granule of each of these vbr_v2 clips ends so; the
    benchmark's frozen reference still flags it (ERR_HUFFMAN_OVERRUN), the
    port's unpackers flag nothing and agree, and the scheduler counts no
    frame in error."""
    from mp3bench.reference.bitstream import unpack as ref_unpack
    from mp3tpu_torch import metrics
    from mp3tpu_torch.bitstream import native
    from mp3tpu_torch.bitstream.unpack import unpack
    with open(os.path.join(BENCH, "corpus", "vbr_v2", f"{clip}.mp3"),
              "rb") as f:
        data = f.read()
    assert np.count_nonzero(ref_unpack.unpack(data).errors == 2) == 1
    a = unpack(data)
    assert not np.asarray(a.errors).any()
    if native.available():
        b = native.unpack_native(data)
        for field in ("is_", "exp", "errors", "huff_slack", "lines_used"):
            assert np.array_equal(getattr(a, field), getattr(b, field))
    before = metrics.GLOBAL.frames_error
    mp3tpu_torch.decode_batch([data], device="cpu", output="pcm")
    assert metrics.GLOBAL.frames_error == before
