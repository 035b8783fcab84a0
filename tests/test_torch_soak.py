"""The port's scheduler soak (mp3tpu_torch.soak) on the CPU, held against the
JAX harness (tools/soak.py): the same pool signals, the same corrupted bytes
and expected counts from the same generator state, and a reduced session of
both harnesses on the same pool of committed clips with equal accounting and
fault counters. The hour-scale session runs on the card (chip_smoke.py's
soak phase; docs/soak_torch_r01.json)."""
import copy
import os

import numpy as np
import pytest
import torch

import mp3tpu.encoder
import soak as jax_soak
from mp3tpu_torch import encoder as port_encoder
from mp3tpu_torch import soak

torch.set_num_threads(1)

CLIPS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_clips")
POOL = ("sweep", "tonal", "transients")
# 6 streams of the 10 s clips: with corrupt_every=2 every corruption kind
# runs once (streams 1, 3, 5), and ring_every=3 drains a clean stream (2)
# and a corrupted one (5)
REDUCED = dict(total_audio_s=55.0, wave_streams=3, corrupt_every=2,
               ring_every=3)
SAME_KEYS = ("n_streams", "n_corrupted", "n_kind", "n_ring_consumers",
             "streams_sample_checked", "ring_samples_drained")
SAME_METRICS = ("frames_ok", "frames_error", "resyncs", "granules_decoded",
                "granules_muted", "samples_out", "streams_finished")


def clip(name: str) -> bytes:
    with open(os.path.join(CLIPS, f"{name}.mp3"), "rb") as f:
        return f.read()


def test_pool_signals_are_the_jax_pools(monkeypatch):
    """The six signals reach the host encoder as the JAX harness hands them
    to its own (encode_pcm is byte for byte the JAX package's)."""
    seen = {"jax": [], "port": []}

    def spy(who):
        def encode_pcm(pcm, sr, bitrate=None, device=None):
            seen[who].append((pcm, sr, bitrate, device))
            return b"%d" % len(seen[who])
        return encode_pcm

    monkeypatch.setattr(mp3tpu.encoder, "encode_pcm", spy("jax"))
    monkeypatch.setattr(port_encoder, "encode_pcm", spy("port"))
    assert soak._pool("cpu") == jax_soak._pool() == [b"1", b"2", b"3", b"4",
                                                      b"5", b"6"]
    assert len(seen["port"]) == 6
    for (a, sr, br, dev), (b, jsr, jbr, _) in zip(seen["port"], seen["jax"]):
        assert np.array_equal(a, b) and a.dtype == b.dtype
        assert (sr, br, dev) == (jsr, jbr, "cpu") == (44100, 128, "cpu")
    assert [a.ndim for a, *_ in seen["port"]] == [1, 2, 1, 2, 1, 2]


def test_pool_on_a_card_is_one_encode_batch_per_channel_count(monkeypatch):
    calls = []

    def encode_batch(pcms, sr, bitrate=None, device=None):
        calls.append(([p.shape for p in pcms], sr, bitrate, device))
        return [b"%d/%d" % (p.ndim, i) for i, p in enumerate(pcms)]

    monkeypatch.setattr(port_encoder, "encode_batch", encode_batch)
    pool = soak._pool(torch.device("cuda"))
    assert pool == [b"1/0", b"2/0", b"1/1", b"2/1", b"1/2", b"2/2"]
    sigs = soak._signals()
    assert calls == [([sigs[i].shape for i in (0, 2, 4)], 44100, 128,
                      torch.device("cuda")),
                     ([sigs[i].shape for i in (1, 3, 5)], 44100, 128,
                      torch.device("cuda"))]


@pytest.mark.parametrize("name", ["sweep", "tonal"])
@pytest.mark.parametrize("kind", ["flip", "cut", "header"])
def test_corruption_is_the_jax_harness_bytes(name, kind):
    """The same bytes and generator state give the same corrupted bytes and
    leave the generator where the JAX helper leaves it; the expected counts
    of the clean and the corrupted stream are the JAX harness's."""
    data = clip(name)
    port_fn = dict(soak._CORRUPTIONS)[kind]
    jax_fn = dict(jax_soak._CORRUPTIONS)[kind]
    for seed in (5, 17):
        rp, rj = np.random.default_rng(seed), np.random.default_rng(seed)
        got, want = port_fn(data, rp), jax_fn(data, rj)
        assert got == want and got != data
        assert rp.integers(1 << 30) == rj.integers(1 << 30)
        assert soak._expected_samples(got) == jax_soak._expected_samples(want)
    assert soak._expected_samples(data) == jax_soak._expected_samples(data)


@pytest.fixture(scope="module")
def reports():
    pool = [clip(n) for n in POOL]
    port = soak.run_soak(device="cpu", pool=pool, **REDUCED)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_soak, "_pool", lambda: pool)
        ref = jax_soak.run_soak(**REDUCED)
    return port, ref


def test_reduced_session_equals_the_jax_harness(reports):
    port, ref = reports
    for key in SAME_KEYS:
        assert port[key] == ref[key], key
    for key in SAME_METRICS:
        assert port["metrics"][key] == ref["metrics"][key], key
    assert all(v == 1 for v in port["n_kind"].values())
    assert port["n_streams"] == 6 and port["n_ring_consumers"] == 2
    assert [len(w) for w in (port["waves"], ref["waves"])] == [2, 2]
    # every clean stream no ring drains went to the checking sink (the JAX
    # harness checks at most 3, through CollectSink)
    assert port["clean_streams_checked"] == ref["clean_streams_checked"] == 2
    assert port["steps"] > 0 and port["device"] == "cpu"
    assert port["rss_before_prepare_mb"] > 0


def test_check_report_passes_on_the_reduced_session(reports):
    """Every accounting, fault and memory invariant of check_report holds on
    the reduced session (check_session), and on it as a card's report.
    check_rates' two invariants compare the wall-clock rates of two waves of
    about 1 s each on a host that other test workers share: they measure the
    host, not the program (a run under load read a last third at 14.1x
    realtime against a first at 24.7x). The card's hour-scale session holds
    them (chip_smoke.py's soak phase, through check_report), and here the
    planted _decay must fail check_report."""
    port, _ = reports
    soak.check_session(port)
    assert port["clean_max_abs_lsb"] == 0 and port["clean_min_exact"] == 1.0
    assert port["device_alloc_growth_post_warmup_mb"] is None
    assert port["min_wave_x"] > 0 and port["first_third_x"] > 0
    card = copy.deepcopy(port)
    _on_a_card(card, 0.25)
    soak.check_session(card)


def _off_by_one(rep):
    rep["accounting"][3][4] += 1


def _stream_lost(rep):
    rep["metrics"]["streams_finished"] -= 1


def _clean_two_lsb(rep):
    rep["clean_max_abs_lsb"] = 2


def _clean_unchecked(rep):
    rep["accounting"][0][2] = "count"


def _underrun(rep):
    rep["metrics"]["underruns"] = 1


def _no_resync(rep):
    rep["metrics"]["resyncs"] = 0


def _decay(rep):
    rep["last_third_x"] = 0.5 * rep["first_third_x"]


def _on_a_card(rep, alloc_step_mb):
    """The report as a card's, with memory_allocated rising by
    alloc_step_mb a wave over four waves."""
    rep["device"] = "cuda:0"
    rep["waves"] += copy.deepcopy(rep["waves"])
    for i, w in enumerate(rep["waves"]):
        w["device_alloc_mb"] = 40.0 + alloc_step_mb * i
        w["device_reserved_mb"] = 64.0
    rep.update(soak.memory_growth(rep["waves"]))


def _device_leak(rep):
    _on_a_card(rep, 2.0)


def _device_alloc_falls(rep):
    _on_a_card(rep, -2.0)


@pytest.mark.parametrize("broken", [
    _off_by_one, _stream_lost, _clean_two_lsb, _clean_unchecked, _underrun,
    _no_resync, _decay, _device_leak, _device_alloc_falls],
    ids=lambda f: f.__name__.strip("_"))
def test_check_report_raises_on_a_broken_invariant(reports, broken):
    rep = copy.deepcopy(reports[0])
    broken(rep)
    with pytest.raises(AssertionError, match="soak: "):
        soak.check_report(rep)
