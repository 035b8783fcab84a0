"""The songs cell (vbr_v2.songs_decode): the plan's
lengths and clips, the composed VBR streams, the scheduler's per-layer
metrics on a hand-made span table, and whole runs on the CPU at a cut
size, correct unbroken and not correct with a fault planted under the
scheduler or through the songs entry."""
from types import SimpleNamespace

import numpy as np
import pytest

from conftest import ROOT

CELLS = ["vbr_v2.songs_decode"]
SCHED_METRICS = ("sched.intake_share.songs", "sched.unpack_ms_per_stream.songs",
                 "sched.step_share.songs", "sched.slot_occupancy.songs")
# the decode metrics whose layers the songs path runs too
DECODE_METRICS = ("scan_ms_per_stream.decode", "h2d_ms_per_call.decode",
                  "device.idle_share.decode", "device.idle_unnamed_share.decode")


def test_the_plan_takes_the_lengths_twice_and_each_clip_equally():
    from mp3bench import compose
    from mp3bench.entries.decode_songs import song_plan
    a = song_plan(32, 15, 30, 8, compose.rng(2 ** 40 + 3, 2, 0))
    b = song_plan(32, 15, 30, 8, compose.rng(2 ** 40 + 4, 2, 0))
    for plan in (a, b):
        assert sorted(map(len, plan)) == sorted(list(range(15, 31)) * 2)
        assert (np.bincount(np.concatenate(plan), minlength=8) == 90).all()
    assert a != b and [len(p) for p in a] != [len(p) for p in b]
    with pytest.raises(ValueError):
        song_plan(24, 15, 30, 8, compose.rng(1))
    with pytest.raises(ValueError):
        song_plan(8, 2, 3, 8, compose.rng(1))


@pytest.mark.parametrize("workload", CELLS)
def test_the_songs_cell_repeats_its_work_for_any_seed(workload, monkeypatch):
    """The cell's own mix (16 songs of 15-30 parts, 3,600 s of audio a
    batch) on clips cut to 4 frames: the same seed the same bytes, another
    seed the same lengths and as many bytes a batch, in another order."""
    from conftest import cut_clips
    from mp3bench import compose, spec
    from mp3bench.entries import decode_songs
    orig = compose.load_corpus
    monkeypatch.setattr(compose, "load_corpus",
                        lambda config, root: cut_clips(orig(config, root), 4))
    cell = spec.load_cell(workload)
    assert spec.load_entry(cell.entry) is decode_songs
    a, b, c = (decode_songs.prepare(cell, s) for s in (2 ** 31 + 5,
                                                        2 ** 31 + 5, 6))
    assert [x.inputs for x in a.batches] == [x.inputs for x in b.batches]
    for w in (a, c):
        assert len(w.batches) == 2
        for batch in w.batches:
            assert len(batch.inputs) == 16
            assert sum(map(len, batch.plan)) * 10 == 3600
    for x, y in zip(a.batches, c.batches):
        assert x.inputs != y.inputs
        assert sorted(map(len, x.plan)) == sorted(map(len, y.plan))
        assert sum(map(len, x.inputs)) == sum(map(len, y.inputs))


def test_a_composed_vbr_song_keeps_its_frames_counts_and_trim():
    from mp3bench import compose, spec
    from mp3bench.reference.container import frames as fr
    from mp3bench.reference.container.xing import parse_stream_info
    cfg = spec.load_json(f"{ROOT}/benchmark/configs/vbr_v2.json")
    clips = compose.load_corpus(cfg, ROOT)
    parts = [clips[i] for i in (1, 4, 1, 7)]
    data = compose.compose(parts)
    index = fr.scan_frames(np.frombuffer(data, np.uint8))
    assert index.n_frames == 1 + 4 * 384 and index.resyncs == 0
    assert len({h.bitrate for h in index.headers[1:]}) >= 4
    info = parse_stream_info(data, 0, index.headers[0])
    assert info.kind == "xing" and info.toc is not None and info.gapless
    assert info.n_frames == 4 * 384 and info.n_bytes == len(data)
    assert (info.encoder_delay, info.encoder_padding) == (
        parts[0].delay, parts[-1].padding)
    offs = list(index.offsets) + [len(data)]
    assert b"".join(data[x:y] for x, y in zip(offs[1:], offs[2:])) == b"".join(
        p.audio for p in parts)


def test_the_vbr_manifest_records_its_bitrates():
    from mp3bench import spec
    cfg = spec.load_json(f"{ROOT}/benchmark/configs/vbr_v2.json")
    man = spec.load_json(f"{ROOT}/benchmark/corpus/vbr_v2/manifest.json")
    assert man["vbr_quality"] == cfg["format"]["vbr_quality"]
    assert len(man["clips"]) == 8
    # LAME -V 2's band, and frames of changing size in every clip
    assert 170 <= man["mean_kbps"] <= 210
    for c in man["clips"]:
        assert c["distinct_bitrates"] == len(c["bitrates_kbps"]) >= 3
        assert min(c["bitrates_kbps"]) * 0.999 <= c["mean_kbps"]
        assert c["mean_kbps"] <= max(c["bitrates_kbps"]) * 1.001
        assert f"{c['kind']} {c['mean_kbps']:.3f}/{c['distinct_bitrates']}" in (
            cfg["assumed"]["bitrate"])


def tot(total_s, count=1, items=0):
    return {"count": count, "total_s": total_s, "self_s": total_s,
            "items": items}


TOTALS = {"mp3tpu.decode_files": tot(10.0, 2, 64),
          "mp3tpu.decode_batch_streams": tot(9.0, 2, 64),
          "mp3tpu.scan": tot(2.0, 64, 64),
          "mp3tpu.probe_granules": tot(0.1, 2, 64),
          "mp3tpu.sched.load": tot(2.4, 64, 64),
          "mp3tpu.sched.unpack": tot(1.5, 64, 700000),
          "mp3tpu.sched.pack": tot(1.0, 1442, 32400),
          "mp3tpu.sched.route": tot(2.0, 1440, 46080)}


def ctx_of(last, n_snaps=2, trace=None):
    snaps = {} if last is None else {"spans": [{}] * (n_snaps - 1) + [last]}
    return SimpleNamespace(probe=SimpleNamespace(snapshots=snaps),
                           calls=[5.0, 5.0], trace=trace)


@pytest.mark.parametrize("name, want", [
    ("sched.intake_share.songs", 60.0),          # 6.0 s of 10 s
    ("sched.unpack_ms_per_stream.songs", 1500 / 64),
    ("sched.step_share.songs", 30.0),            # 3.0 s of 10 s
    ("sched.slot_occupancy.songs", 100 * 32400 / 46080),
])
def test_the_scheduler_readers_read_the_window_totals(name, want):
    from mp3bench import spec
    r = spec.load_metric(name)
    assert r.read(ctx_of(TOTALS)) == pytest.approx(want)
    # the scheduler called directly: its root is the wall
    direct = {k: v for k, v in TOTALS.items() if k != "mp3tpu.decode_files"}
    got = r.read(ctx_of(direct))
    if name.endswith("share.songs"):
        assert got == pytest.approx(want * 10 / 9)
    else:
        assert got == pytest.approx(want)


@pytest.mark.parametrize("name", SCHED_METRICS)
def test_the_scheduler_readers_find_nothing_without_its_spans(name):
    """The parent program has no mp3tpu.sched.* spans: nothing is read."""
    from mp3bench import spec
    r = spec.load_metric(name)
    assert r.read(ctx_of(None)) is None
    assert r.read(ctx_of({})) is None
    fast = {k: v for k, v in TOTALS.items() if not k.startswith("mp3tpu.sched")}
    assert r.read(ctx_of(fast)) is None


@pytest.fixture
def songs_small(monkeypatch):
    """A songs cell at a test size: 16 songs of 1-2 clips cut to 16 frames,
    with the program's staging cap at 1 MB so that every batch goes to the
    scheduler as whole songs do."""
    from conftest import cut_clips
    from mp3bench import compose, spec
    from mp3tpu_torch import config as port_config
    orig = compose.load_corpus
    monkeypatch.setattr(compose, "load_corpus",
                        lambda config, root: cut_clips(orig(config, root), 16))
    port_config.set_active(port_config.resolve(decode={"batch_max_mb": 1}))

    def make(workload):
        cell = spec.load_cell(workload)
        cell.traffic.update(streams_per_call=16, song_parts=[1, 2],
                            distinct_batches=2, trace_calls=1,
                            check_streams=3)
        cell.traffic["warmup"] = {"min_calls": 1, "max_calls": 1,
                                  "agree_pct": 3}
        return cell
    yield make
    port_config.set_active(port_config.resolve())


def run(cell, trace=False):
    from mp3bench import main
    return main.measure(cell, 2 ** 31 + 23, 0.3, trace, 0.0, device="cpu",
                        log=lambda s: None)


@pytest.mark.parametrize("workload", CELLS)
def test_a_traced_songs_run_reads_every_new_metric(songs_small, workload):
    cell = songs_small(workload)
    r = run(cell, trace=True)
    assert r["correct"] and r["failed"] == 0
    # h2d_ms_per_call.decode reads the card's HtoD copies: none on the CPU
    for m in SCHED_METRICS + DECODE_METRICS:
        if m != "h2d_ms_per_call.decode":
            assert isinstance(r["metrics"][m]["value"], float), m
    # songs of 1 and 2 windows: 3 of every 4 slot-steps hold a stream
    assert r["metrics"]["sched.slot_occupancy.songs"]["value"] == 75.0


def test_a_scheduler_that_hands_its_state_on_unchanged_is_not_correct(
        songs_small, monkeypatch):
    """The scheduler's window step keeps its state: no overlap-add or
    synthesis history crosses a window, and the songs entry's check sees
    it."""
    from mp3tpu_torch.kernels import pipeline as kp
    cell = songs_small("vbr_v2.songs_decode")
    assert run(cell)["correct"]
    orig = kp.decode_window_i16

    def step(*a):
        pcm, _new = orig(*a)
        return pcm, a[5]
    monkeypatch.setattr(kp, "decode_window_i16", step)
    r = run(cell)
    assert not r["correct"], r["checks"]
    assert r["checks"]["max_lsb"]["value"] > 1


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_the_entry_faults_reach_the_songs_entry(songs_small, fault):
    from mp3bench import faults, spec
    cell = songs_small("vbr_v2.songs_decode")
    spec.load_entry(cell.entry)     # registers the entry's fault targets
    assert not faults.applies("window_state", cell.entry)
    with faults.plant(fault, cell.entry):
        r = run(cell)
    assert not r["correct"], (fault, r["checks"])


def test_the_songs_cell_lists_its_metrics():
    """Every per-layer metric listed on the songs cell is read there: the
    scheduler's four and the decode metrics whose layers the path runs."""
    from mp3bench import spec
    bench = spec.load_json(f"{ROOT}/BENCHMARK.json")
    for cell in CELLS:
        listed = {m["name"] for m in bench["per_layer"]
                  if cell in m.get("workloads", [])}
        assert listed == set(SCHED_METRICS + DECODE_METRICS), cell
