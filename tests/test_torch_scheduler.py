"""The PyTorch port's StreamScheduler and decode_batch_streams on the CPU,
held against the JAX package's on the same streams; and every batch that
the fast path of mp3tpu_torch.decode_batch cannot take, which now goes to
the scheduler as in the JAX package, held against mp3tpu.decode_batch with
the same fault books. Each package keeps its own config and fault books
(mp3tpu.config/metrics and mp3tpu_torch.config/metrics): a route is set in
both, and each package's books are read from its own."""
import contextlib
import importlib

import numpy as np
import pytest

import fixtures
import mp3tpu
import mp3tpu_torch
from mp3tpu import config as jax_config
from mp3tpu.player import CollectSink as JaxSink
from mp3tpu.player import StreamScheduler as JaxScheduler
from mp3tpu_torch import config as port_config
from mp3tpu_torch import metrics as port_metrics
from mp3tpu_torch import pipeline as tpl
from mp3tpu_torch.container import frames as fr
from mp3tpu_torch.player import CollectSink, StreamScheduler, decode_batch_streams
from test_torch_decode import assert_i16_close

jax_metrics = importlib.import_module("mp3tpu.metrics")
BOOKS = ("frames_ok", "frames_error", "granules_muted", "resyncs")


@pytest.fixture(scope="module")
def mp3():
    pytest.importorskip("lameref")
    return fixtures.lame_fixture("sweep", ch=2, bitrate=128, mode="jstereo")


@pytest.fixture(scope="module")
def streams(mp3):
    return {"s0": mp3,
            "s1": fixtures.lame_fixture("transients", ch=2, bitrate=128,
                                        mode="jstereo"),
            "s2": fixtures.lame_fixture("tonal", bitrate=128, mode="jstereo")}


@contextlib.contextmanager
def global_delta(out: dict, metrics_mod=port_metrics):
    """The growth of one package's process-wide fault books inside the
    block (the port's by default)."""
    before = dict(metrics_mod.GLOBAL.to_dict())
    yield
    after = metrics_mod.GLOBAL.to_dict()
    out.update({k: after[k] - before.get(k, 0) for k in BOOKS})


def run_both(datas, n_slots, win, **run_kw):
    """The same submissions through both schedulers -> ({sid: port pcm},
    {sid: JAX pcm}, port scheduler, JAX scheduler)."""
    out = []
    for Sched, Sink, kw in ((StreamScheduler, CollectSink, {"device": "cpu"}),
                            (JaxScheduler, JaxSink, {})):
        sched = Sched(n_slots=n_slots, win=win, sample_rate=44100, **kw)
        sinks = {sid: Sink() for sid in datas}
        for sid, d in datas.items():
            sched.submit(d, sink=sinks[sid], stream_id=sid)
        sched.run(**run_kw)
        out.append(({sid: s.pcm for sid, s in sinks.items()}, sched))
    (got, ts), (want, js) = out
    return got, want, ts, js


def test_scheduler_matches_jax_elastic(streams):
    """Five streams through two slots: slots drain and refill; every
    stream within 1 LSB of the JAX scheduler, the same counters."""
    datas = dict(streams, s3=streams["s0"], s4=streams["s1"])
    got, want, ts, js = run_both(datas, n_slots=2, win=16)
    for sid in datas:
        assert len(got[sid]) > 50000
        assert_i16_close(got[sid], want[sid])
    assert ts.metrics.streams_finished == js.metrics.streams_finished == 5
    for k in BOOKS + ("granules_decoded", "samples_out"):
        assert getattr(ts.metrics, k) == getattr(js.metrics, k), k
    # one step in flight: window w+1 is enqueued before window w is routed
    pos = {ev: i for i, ev in enumerate(ts.trace)}
    n = sum(1 for kind, _ in ts.trace if kind == "dispatch")
    assert n >= 6 and all(pos[("dispatch", w + 1)] < pos[("route", w)]
                          for w in range(n - 1))


def test_decode_batch_streams_matches_jax_and_decode(streams):
    datas = list(streams.values())
    want = mp3tpu.player.decode_batch_streams(datas)
    got = decode_batch_streams(datas, device="cpu")
    for (g, gs), (w, ws), d in zip(got, want, datas):
        assert gs == ws
        assert_i16_close(g, w)
        # gapless-trimmed like the single-file decode of the port
        assert_i16_close(g, mp3tpu_torch.decode(d, device="cpu")[0])


def test_submit_bounds_from_one_scan(streams, monkeypatch):
    """submit(bytes) takes the gapless bounds from load_source's parse, equal
    to the JAX package's second scan, and never scans the stream again."""
    from mp3tpu.player.scheduler import gapless_bounds_of as jax_bounds_of
    from mp3tpu_torch.player import scheduler
    for d in streams.values():
        st, info, _index = tpl.load_source(d)
        got = scheduler.info_bounds(info, st.n_granules)
        assert got[1] is not None
        assert got == jax_bounds_of(d, st.n_granules)
        assert got == scheduler.gapless_bounds_of(d, st.n_granules)

    def rescan(*a, **kw):
        raise AssertionError("submit scanned the stream a second time")

    monkeypatch.setattr(scheduler, "gapless_bounds_of", rescan)
    got, want, _ts, _js = run_both({"s0": streams["s0"]}, n_slots=1, win=16)
    assert_i16_close(got["s0"], want["s0"])


def test_checkpoint_resume_bit_identical(streams):
    """A run checkpointed mid-way and resumed on a fresh scheduler gives
    the uninterrupted run's PCM bit for bit."""
    def build():
        sched = StreamScheduler(n_slots=2, win=8, sample_rate=44100,
                                device="cpu")
        sinks = {sid: CollectSink() for sid in streams}
        for sid, d in streams.items():
            sched.submit(d, sink=sinks[sid], stream_id=sid)
        return sched, sinks

    ref_sched, ref_sinks = build()
    ref_sched.run()
    sched, sinks = build()
    snaps = []
    sched.run(max_steps=3, checkpoint_every=3, on_checkpoint=snaps.append)
    assert snaps
    resumed = StreamScheduler(n_slots=2, win=8, sample_rate=44100,
                              device="cpu")
    tails = {}

    def sink_for(sid):
        tails[sid] = CollectSink()
        return tails[sid]

    resumed.restore(snaps[-1], resolve=streams.__getitem__, sink_for=sink_for)
    resumed.run()
    for sid in streams:
        got = np.concatenate([sinks[sid].pcm, tails[sid].pcm
                              if sid in tails else np.zeros((0, 2), np.int16)])
        assert np.array_equal(got, ref_sinks[sid].pcm), sid


def test_jax_snapshot_resumes_in_port(streams):
    """The JAX scheduler's snapshot() dict restores into the port's
    scheduler, which continues within 1 LSB of the JAX continuation."""
    def build(Sched, Sink, **kw):
        sched = Sched(n_slots=2, win=8, sample_rate=44100, **kw)
        for sid, d in streams.items():
            sched.submit(d, sink=Sink(), stream_id=sid)
        return sched

    snaps = []
    build(JaxScheduler, JaxSink).run(max_steps=4, checkpoint_every=4,
                                     on_checkpoint=snaps.append)
    tails = []
    for Sched, Sink, kw in ((StreamScheduler, CollectSink, {"device": "cpu"}),
                            (JaxScheduler, JaxSink, {})):
        sinks = {}

        def sink_for(sid):
            sinks[sid] = Sink()
            return sinks[sid]

        sched = Sched(n_slots=2, win=8, sample_rate=44100, **kw)
        sched.restore(snaps[-1], resolve=streams.__getitem__, sink_for=sink_for)
        sched.run()
        tails.append({sid: s.pcm for sid, s in sinks.items()})
    assert tails[0].keys() == tails[1].keys() and tails[0]
    for sid in tails[0]:
        assert len(tails[0][sid]) > 10000
        assert_i16_close(tails[0][sid], tails[1][sid])


# ---- batches the fast path cannot take (mp3tpu/pipeline.py:688-698, :795-809)

def reservoir_cut(mp3):
    from soak import _corrupt_cut
    return _corrupt_cut(mp3, np.random.default_rng(5))


@contextlib.contextmanager
def decode_config(**decode):
    """The same decode settings active in both packages."""
    for cfg in (jax_config, port_config):
        cfg.set_active(cfg.resolve(decode=decode))
    try:
        yield
    finally:
        for cfg in (jax_config, port_config):
            cfg.set_active(cfg.resolve())


def assert_batch_and_books_match(datas, route=contextlib.nullcontext):
    """mp3tpu_torch.decode_batch vs mp3tpu.decode_batch on the same bytes,
    both under `route`: each stream within 1 LSB and 98% exact, the same
    global fault books."""
    d_jax, d_port = {}, {}
    with route(), global_delta(d_jax, jax_metrics):
        want = mp3tpu.decode_batch(datas, gapless=False)
    with route(), global_delta(d_port):
        got = mp3tpu_torch.decode_batch(datas, gapless=False, device="cpu")
    assert len(got) == len(want)
    for (g, gs), (w, ws) in zip(got, want):
        assert gs == ws
        assert_i16_close(g, w)
    assert d_port == d_jax, (d_port, d_jax)


def spy_scheduler(monkeypatch):
    """Count the port's calls of decode_batch_streams."""
    from mp3tpu_torch.player import scheduler
    calls = []
    real = scheduler.decode_batch_streams

    def spy(datas, **kw):
        calls.append(len(datas))
        return real(datas, **kw)

    monkeypatch.setattr(scheduler, "decode_batch_streams", spy)
    return calls


@pytest.mark.parametrize("case", ["use_native_off", "over_batch_max_mb",
                                  "reservoir_cut_first_frame",
                                  "probe_refuses", "no_plane_holds"])
def test_fast_path_refusals_go_to_scheduler(case, mp3, streams, monkeypatch):
    datas = [mp3, streams["s1"]]
    route = contextlib.nullcontext
    if case == "use_native_off":
        route = lambda: decode_config(use_native=False)
    elif case == "over_batch_max_mb":
        route = lambda: decode_config(batch_max_mb=1)
    elif case == "reservoir_cut_first_frame":
        datas = [mp3, reservoir_cut(mp3)]
    elif case == "probe_refuses":
        monkeypatch.setattr(tpl, "probe_granules", lambda body: -1)
    else:
        monkeypatch.setattr(tpl, "unpack_planes", lambda *a, **kw: None)
    calls = spy_scheduler(monkeypatch)
    assert_batch_and_books_match(datas, route)
    assert calls == [len(datas)]


def test_over_budget_chunk_merges_with_fast_chunks(mp3, streams, monkeypatch):
    """Only the chunk over decode.batch_max_mb goes to the scheduler; the
    fast chunks' results and books stay, in input order."""
    long = fixtures.lame_fixture("sweep", ch=2, bitrate=128, mode="jstereo",
                                 seconds=4.0)
    datas = [mp3, long, streams["s2"]]
    calls = spy_scheduler(monkeypatch)
    # one stream per chunk: the 2 s chunks stage about 0.7 MB, the 4 s
    # chunk 1.5 MB
    route = lambda: decode_config(batch_chunk_streams=1, batch_max_mb=1)
    assert_batch_and_books_match(datas, route)
    assert calls == [1]


def test_chaos_batch_all_kinds(mp3):
    """tests/test_faults.py's chaos batch (byte flips, reservoir cut,
    header kill) through the port: books equal to the JAX batch's and to
    the single-file decodes', each stream within 1 LSB."""
    from soak import _CORRUPTIONS
    rng = np.random.default_rng(11)
    streams = [mp3] + [fn(mp3, rng) for _name, fn in _CORRUPTIONS] + [mp3]
    d_single: dict = {}
    with global_delta(d_single):
        singles = [mp3tpu_torch.decode(s, gapless=False, device="cpu")
                   for s in streams]
    assert d_single["frames_error"] > 0 and d_single["granules_muted"] > 0
    assert d_single["resyncs"] > 0
    d_port: dict = {}
    with global_delta(d_port):
        outs = mp3tpu_torch.decode_batch(streams, gapless=False, device="cpu")
    assert d_port == d_single, (d_port, d_single)
    want = mp3tpu.decode_batch(streams, gapless=False)
    for (ref, rsr), (got, gsr), (w, _) in zip(singles, outs, want):
        assert gsr == rsr
        assert_i16_close(got, ref)
        assert_i16_close(got, w)


def test_lone_metadata_frame_decodes_empty(mp3):
    """A stream that is only its Xing/Info frame has no audio: the port's
    scheduler returns empty PCM for it and decodes the rest of the batch
    (the JAX package's scheduler never drains such a slot)."""
    idx = fr.scan_frames(np.frombuffer(mp3, np.uint8))
    lone = mp3[: int(idx.offsets[1])]
    got = mp3tpu_torch.decode_batch([lone, mp3], device="cpu")
    assert got[0][0].shape == (0, 2)
    assert_i16_close(got[1][0], mp3tpu.decode_batch([mp3])[0][0])
