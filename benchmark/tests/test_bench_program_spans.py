"""The per-layer metrics that read the program's own spans
(mp3tpu_torch.utils.profiling.TOTALS) and the device idle that no program
range names: each reader on a hand-made ctx, its None cases, its
instrument() against a program with and without the spans, and a traced
run of each cell on the CPU in which every one of them finds something to
read."""
import os
from types import SimpleNamespace

import pytest

from mp3bench import spec
from mp3bench.probe import Probe

SPAN_METRICS = ("d2h.wait_ms_per_call.decode", "d2h.slice_ms_per_call.decode",
                "unpack.overflow_share.decode",
                "transcode.decode_share.transcode",
                "encode.emit_mux_share.encode")
IDLE_METRICS = tuple(f"device.idle_unnamed_share.{c}"
                     for c in ("decode", "encode", "transcode"))


def tot(total_s, count=1):
    return {"count": count, "total_s": total_s, "self_s": total_s, "items": 0}


def ctx_of(last=None, n_snaps=2, calls=(0.5, 0.5, 9.0), trace=None):
    snaps = {} if last is None else {"spans": [{}] * (n_snaps - 1) + [last]}
    return SimpleNamespace(probe=SimpleNamespace(snapshots=snaps),
                           calls=list(calls), trace=trace)


TOTALS = {"mp3tpu.d2h.wait": tot(0.03, 4), "mp3tpu.slice": tot(0.4, 2),
          "mp3tpu.unpack": tot(0.5, 2),
          "mp3tpu.unpack.pass/overflow": tot(0.2, 6),
          "mp3tpu.unpack.pass/ok": tot(0.28, 2),
          "mp3tpu.decode_files": tot(0.25, 2),
          "mp3tpu.encode.emit": tot(0.1, 4), "mp3tpu.encode.mux": tot(0.05, 2)}


@pytest.mark.parametrize("name, want", [
    ("d2h.wait_ms_per_call.decode", 15.0),       # 30 ms over 2 calls
    ("d2h.slice_ms_per_call.decode", 200.0),
    ("unpack.overflow_share.decode", 40.0),      # 0.2 s of 0.5 s
    ("transcode.decode_share.transcode", 25.0),  # 0.25 s of the first 2 walls
    ("encode.emit_mux_share.encode", 15.0),
])
def test_span_readers_read_the_window_totals(name, want):
    r = spec.load_metric(name)
    assert r.read(ctx_of(TOTALS)) == pytest.approx(want)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_readers_find_nothing_without_the_spans(name):
    r = spec.load_metric(name)
    assert r.read(ctx_of(None)) is None
    assert r.read(ctx_of({})) is None            # the span never opened
    other = {k: v for k, v in TOTALS.items() if k.startswith("mp3tpu.zzz")}
    assert r.read(ctx_of(other)) is None


def test_no_overflow_reads_zero_and_an_empty_window_none():
    r = spec.load_metric("unpack.overflow_share.decode")
    assert r.read(ctx_of({"mp3tpu.unpack": tot(0.5)})) == 0.0
    assert r.read(ctx_of({"mp3tpu.unpack": tot(0.0)})) is None
    for name in ("transcode.decode_share.transcode",
                 "encode.emit_mux_share.encode"):
        assert spec.load_metric(name).read(ctx_of(TOTALS, calls=())) is None
    mux_only = spec.load_metric("encode.emit_mux_share.encode").read(
        ctx_of({"mp3tpu.encode.mux": tot(0.05)}))
    assert mux_only == pytest.approx(5.0)


@pytest.mark.parametrize("name", IDLE_METRICS)
def test_idle_unnamed_share_counts_roots_and_other_names_as_unnamed(name):
    r = spec.load_metric(name)
    trace = {"window_s": 10.0, "busy_s": 2.0, "idle_gaps": [
        ["mp3tpu.scan", 3.0], ["mp3tpu.unpack.run", 2.0],
        ["bench.scan", 1.0], ["(between ranges)", 0.5],
        ["mp3tpu.decode_files", 0.5], ["mp3tpu.encode_batch", 0.25],
        ["mp3tpu.transcode_batch", 0.25], ["mp3tpu.encode.passA", 0.5]]}
    # named: 3 + 2 + 0.5 of 8 s idle
    assert r.read(ctx_of(trace=trace)) == pytest.approx(100 * 2.5 / 8)
    assert r.read(ctx_of(trace=None)) is None
    assert r.read(ctx_of(trace=dict(trace, busy_s=10.0))) is None
    assert r.read(ctx_of(trace=dict(trace, idle_gaps=[]))) == 100.0


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_instrument_asks_for_the_spans_only_where_the_program_has_them(
        name, monkeypatch):
    from mp3tpu_torch.utils import profiling
    r = spec.load_metric(name)
    p = Probe()
    r.instrument(p)
    try:
        assert os.environ["MP3TPU_SPANS"] == "1"
        assert p._snap["spans"][:2] == ("mp3tpu_torch.utils.profiling",
                                        "TOTALS")
        profiling.TOTALS["x"] = tot(1.0)
        p.open_window()
        assert profiling.TOTALS == {}        # cleared in place
    finally:
        p.close_window()
        p.restore()
    monkeypatch.delattr(profiling, "TOTALS")
    p = Probe()
    r.instrument(p)
    assert p._snap == {} and p._undo == []


@pytest.mark.parametrize("workload", ["cbr320.batch_decode",
                                      "cbr128.upload_encode",
                                      "cbr320.rendition_transcode"])
def test_a_traced_run_reports_every_new_metric(small, workload):
    """A whole traced run of each cell at a test size on the CPU: each new
    metric of the cell has a value."""
    from mp3bench import main
    cell = small(workload)
    r = main.measure(cell, 2 ** 31 + 17, 0.3, True, 0.0, device="cpu",
                     log=lambda s: None)
    assert r["correct"]
    mine = [m["name"] for m in cell.per_layer
            if m["name"] in SPAN_METRICS + IDLE_METRICS]
    assert len(mine) >= 2
    for m in mine:
        assert isinstance(r["metrics"][m]["value"], float), m
    assert "MP3TPU_SPANS" not in os.environ
