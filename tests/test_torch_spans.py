"""mp3tpu_torch.utils.profiling's spans on the CPU (and, marked cuda, on the
card): nothing kept while recording is off; parents, request ids and self
times while it is on; TOTALS and the ring cleared in place; the spans on
torch.profiler's clock, and its ranges on a torch without the profiler's
flag; the decode, encode and transcode paths' spans where the work
happens; and the same outputs with recording on and off."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mp3tpu_torch
from mp3tpu_torch import config as port_config
from mp3tpu_torch.utils import profiling

torch.set_num_threads(1)  # one torch thread a pytest-xdist worker
CLIPS = os.path.join(os.path.dirname(__file__), "torch_clips")
SR = 44100


def clip_bytes(name):
    with open(os.path.join(CLIPS, f"{name}.mp3"), "rb") as f:
        return f.read()


def short_pcms():
    """Two int16-origin stereo streams of 0.4 s and 0.23 s."""
    t = np.arange(int(0.4 * SR)) / SR
    pcm = np.stack([np.sin(2 * np.pi * 330 * t) * 0.5,
                    np.sin(2 * np.pi * 440 * t) * 0.4], 1)
    pcm = np.round(pcm * 32767) / 32768.0
    return [pcm, pcm[:10000]]


def clear():
    for d in (profiling.TOTALS, profiling.RING):
        d.clear()


@pytest.fixture
def spans_off(monkeypatch):
    monkeypatch.delenv("MP3TPU_SPANS", raising=False)
    monkeypatch.delenv("MP3TPU_TRACE_DIR", raising=False)
    with profiling.request("mp3tpu.test_off"):  # reads the switch: off
        pass
    clear()
    yield
    clear()


@pytest.fixture
def spans_on(monkeypatch):
    monkeypatch.delenv("MP3TPU_TRACE_DIR", raising=False)
    monkeypatch.setenv("MP3TPU_SPANS", "1")
    clear()
    yield
    monkeypatch.delenv("MP3TPU_SPANS")
    with profiling.request("mp3tpu.test_off"):
        pass
    clear()


@pytest.fixture
def small_chunks():
    """Chunks of 2 streams: the CPU decodes every row of a chunk."""
    port_config.set_active(port_config.resolve(
        decode={"batch_chunk_streams": 2}))
    yield
    port_config.set_active(port_config.resolve())


def spans(name=None):
    """The ring as dicts, in the order the spans closed."""
    keys = ("name", "t0", "t1", "id", "parent", "request", "items",
            "outcome", "attrs", "thread")
    out = [dict(zip(keys, r)) for r in profiling.RING]
    return [s for s in out if name is None or s["name"] == name]


def test_recording_off_keeps_nothing(spans_off):
    with profiling.request("mp3tpu.root"):
        with profiling.annotate("mp3tpu.child", 3, lo=1) as sp:
            sp.outcome = "overflow"
            sp.items = 7
    assert not profiling._ON
    assert len(profiling.RING) == 0
    assert profiling.TOTALS == {}
    assert profiling.chrome_events() == []


def test_nested_spans_carry_parent_request_and_self_time(spans_on):
    for _ in range(2):
        with profiling.request("mp3tpu.root", 2):
            with profiling.annotate("mp3tpu.a"):
                with profiling.annotate("mp3tpu.a.inner", 5) as sp:
                    sum(range(2000))
                    sp.outcome = "ok"
                sum(range(1000))
            with profiling.request("mp3tpu.nested_root"):
                pass
    assert profiling._ON
    roots = spans("mp3tpu.root")
    assert len(roots) == 2 and roots[0]["request"] != roots[1]["request"]
    assert all(r["parent"] == 0 for r in roots)
    by_id = {s["id"]: s for s in spans()}
    for root in roots:
        tree = [s for s in spans() if s["request"] == root["request"]]
        assert len(tree) == 4
        for s in tree:
            if s["id"] != root["id"]:
                parent = by_id[s["parent"]]
                assert parent["t0"] <= s["t0"] <= s["t1"] <= parent["t1"]
        [inner] = [s for s in tree if s["name"] == "mp3tpu.a.inner"]
        assert by_id[inner["parent"]]["name"] == "mp3tpu.a"
        [nested] = [s for s in tree if s["name"] == "mp3tpu.nested_root"]
        assert nested["parent"] == root["id"]
        # the root's duration is the sum of its tree's self times
        kids = {}
        for s in tree:
            kids.setdefault(s["parent"], []).append(s["t1"] - s["t0"])
        self_ns = [s["t1"] - s["t0"] - sum(kids.get(s["id"], []))
                   for s in tree]
        assert all(x >= 0 for x in self_ns)
        assert abs(sum(self_ns) - (root["t1"] - root["t0"])) <= (
            1000 * len(tree))
    t = profiling.TOTALS
    assert set(t) == {"mp3tpu.root", "mp3tpu.a", "mp3tpu.a.inner/ok",
                      "mp3tpu.nested_root"}
    assert t["mp3tpu.root"]["count"] == 2 and t["mp3tpu.root"]["items"] == 4
    assert t["mp3tpu.a.inner/ok"]["items"] == 10
    total_self = sum(v["self_s"] for v in t.values())
    assert total_self == pytest.approx(t["mp3tpu.root"]["total_s"], abs=8e-6)


def test_a_span_left_by_an_exception_closes_as_error(spans_on):
    with pytest.raises(KeyError):
        with profiling.request("mp3tpu.root"):
            with profiling.annotate("mp3tpu.fails"):
                raise KeyError("x")
    assert set(profiling.TOTALS) == {"mp3tpu.root/error",
                                     "mp3tpu.fails/error"}
    with profiling.request("mp3tpu.root"):  # the stack was left empty
        pass
    assert spans("mp3tpu.root")[-1]["parent"] == 0


def test_totals_and_ring_keep_their_identity_across_clear(spans_on):
    totals, ring = profiling.TOTALS, profiling.RING
    with profiling.request("mp3tpu.root"):
        pass
    totals.clear()
    ring.clear()
    with profiling.request("mp3tpu.root"):
        pass
    assert profiling.TOTALS is totals
    assert profiling.RING is ring and ring.maxlen == 65536
    assert totals["mp3tpu.root"]["count"] == 1 and len(ring) == 1


def test_annotate_enters_the_range_where_torch_lacks_the_flag(spans_off,
                                                              monkeypatch):
    """Without torch.autograd.profiler._is_profiler_enabled every annotate
    enters its record_function range, and a profiler still sees it."""
    from torch.autograd import profiler as autograd_profiler
    monkeypatch.delattr(autograd_profiler, "_is_profiler_enabled")
    with profiling.annotate("mp3tpu.outside") as sp:
        assert sp._rf is not None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.annotate("mp3tpu.flagless", lo=3):
            torch.ones(4).sum()
    assert "mp3tpu.flagless[3]" in {e.key for e in prof.key_averages()}


def test_spans_lie_on_the_profilers_clock(spans_on, tmp_path):
    """A span's exported ts and end lie within 0.5 ms of its own
    record_function range in a torch.profiler trace, after a warm-up
    span."""
    from torch.profiler import ProfilerActivity, profile
    with profiling.request("mp3tpu.warm"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(3):
            with profiling.request("mp3tpu.clock", k=k):
                torch.ones(64).sum()
                with profiling.annotate("mp3tpu.clock.inner"):
                    torch.ones(64).cumsum(0)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = int(trace["baseTimeNanoseconds"])
    assert profiling._trace_base_ns(path) == base
    ranges = sorted((e for e in trace["traceEvents"]
                     if e.get("cat") == "user_annotation"
                     and e["name"].startswith("mp3tpu.clock")),
                    key=lambda e: e["ts"])
    assert [e["name"] for e in ranges] == [
        "mp3tpu.clock[0]", "mp3tpu.clock.inner", "mp3tpu.clock[1]",
        "mp3tpu.clock.inner", "mp3tpu.clock[2]", "mp3tpu.clock.inner"]
    ours = sorted((e for e in profiling.chrome_events(base)
                   if e["name"].startswith("mp3tpu.clock")),
                  key=lambda e: e["ts"])
    assert len(ours) == 6
    for rf, sp in zip(ranges, ours):
        assert rf["name"].split("[")[0] == sp["name"]
        assert abs(sp["ts"] - rf["ts"]) < 500
        assert abs(sp["ts"] + sp["dur"] - rf["ts"] - rf["dur"]) < 500
    assert [sp["args"].get("k") for sp in ours[::2]] == [0, 1, 2]


def test_trace_dir_writes_the_spans_at_exit(tmp_path):
    """MP3TPU_TRACE_DIR turns recording on: decode() leaves the torch trace
    and, at exit, the spans file on the trace's clock."""
    mp3 = os.path.join(CLIPS, "tonal.mp3")
    out = tmp_path / "traces"
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    code = ("import sys, torch; torch.set_num_threads(1)\n"
            f"sys.path.insert(0, {src!r})\n"
            "import mp3tpu_torch\n"
            f"mp3tpu_torch.decode({mp3!r}, device='cpu')\n")
    env = {k: v for k, v in os.environ.items() if k != "MP3TPU_SPANS"}
    env["MP3TPU_TRACE_DIR"] = str(out)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    names = sorted(os.listdir(out))
    [tr] = [n for n in names if n.endswith(".trace.json")]
    [sp] = [n for n in names if n.endswith(".spans.json")]
    with open(out / tr) as f:
        trace = json.load(f)
    with open(out / sp) as f:
        got = json.load(f)
    assert got["baseTimeNanoseconds"] == trace["baseTimeNanoseconds"]
    ranges = sorted((e for e in trace["traceEvents"]
                     if e["name"].startswith("mp3tpu.decode_group[")),
                    key=lambda e: e["ts"])
    ours = sorted((e for e in got["traceEvents"]
                   if e["name"] == "mp3tpu.decode_group"),
                  key=lambda e: e["ts"])
    assert len(ours) == len(ranges) >= 2
    for rf, ev in zip(ranges, ours):
        assert rf["name"] == "mp3tpu.decode_group[{lo}:{hi}]".format(
            **ev["args"])
        assert abs(ev["ts"] - rf["ts"]) < 500


@pytest.mark.parametrize("name, passes", [("sweep", 4), ("tonal", 1)])
def test_decode_files_spans(spans_on, small_chunks, name, passes):
    """sweep widens to 12-bit planes in four passes, three of them
    overflowing; tonal fits the 4-bit planes in one."""
    mp3tpu_torch.decode_batch([clip_bytes(name)], device="cpu")
    t = profiling.TOTALS
    assert len(spans("mp3tpu.unpack.pass")) == passes
    assert t["mp3tpu.unpack.pass/ok"]["count"] == 1
    over = t.get("mp3tpu.unpack.pass/overflow", {"count": 0})
    assert over["count"] == passes - 1
    for k in ("mp3tpu.unpack.alloc", "mp3tpu.unpack.run"):
        assert t[k]["count"] == passes
    assert t["mp3tpu.unpack"]["count"] == t["mp3tpu.unpack"]["items"] == 1
    assert t["mp3tpu.scan"]["count"] == 1 and t["mp3tpu.scan"]["items"] == 1
    assert t["mp3tpu.probe_granules"]["count"] == 1
    assert t["mp3tpu.stage"]["count"] == 1
    n_seg = t["mp3tpu.decode_chunk"]["count"]
    assert n_seg >= 1
    assert (t["mp3tpu.d2h.start"]["count"] == t["mp3tpu.d2h.wait"]["count"]
            == n_seg)
    assert t["mp3tpu.slice"]["count"] == 1 and t["mp3tpu.slice"]["items"] > 0
    assert t["mp3tpu.decode_files"]["count"] == 1
    [root] = spans("mp3tpu.decode_files")
    assert all(s["request"] == root["request"] for s in spans())
    last = spans("mp3tpu.unpack.pass")
    assert last[-1]["attrs"]["plane_bits"] == (12 if passes == 4 else 4)
    assert last[0]["attrs"] == {"plane_bits": 4, "exp_bytes": True}


def test_encode_and_transcode_phases_share_a_request(spans_on, small_chunks):
    mp3s = mp3tpu_torch.encode_batch(short_pcms(), SR, device="cpu")
    [enc] = spans("mp3tpu.encode_batch")
    phases = [s for s in spans() if s["name"].startswith("mp3tpu.encode.")
              and s["name"] not in ("mp3tpu.encode.bisect",
                                    "mp3tpu.encode.labels")]
    assert {s["name"] for s in phases} >= {
        "mp3tpu.encode." + p for p in ("host_prep", "stage", "transform_psy",
                                       "passA", "passB", "emit", "mux")}
    assert all(s["request"] == enc["request"] and s["parent"] == enc["id"]
               for s in phases)
    # the block-type labels are a span inside the staging
    [stage] = spans("mp3tpu.encode.stage")
    [labels] = spans("mp3tpu.encode.labels")
    assert labels["parent"] == stage["id"] and labels["outcome"] == "device"
    # the rate loops' bisections are spans inside the passes
    loops = {s["id"] for s in phases if s["name"] in ("mp3tpu.encode.passA",
                                                      "mp3tpu.encode.passB")}
    bisects = spans("mp3tpu.encode.bisect")
    assert bisects and all(s["parent"] in loops and s["outcome"] == "plain"
                           for s in bisects)
    clear()
    mp3tpu_torch.transcode_batch(mp3s, bitrate=96, device="cpu")
    [root] = spans("mp3tpu.transcode_batch")
    tree = {s["id"]: s for s in spans() if s["request"] == root["request"]}
    assert len(tree) == len(profiling.RING)
    [dec] = spans("mp3tpu.decode_files")
    [enc] = spans("mp3tpu.encode_batch")
    assert dec["parent"] == root["id"] and enc["parent"] == root["id"]
    [intake] = spans("mp3tpu.encode.device_input")
    assert intake["parent"] == enc["id"] and intake["items"] == 2
    assert spans("mp3tpu.device_records")[0]["parent"] != 0
    for s in spans():
        if s["name"] == "mp3tpu.encode.bisect":
            assert tree[s["parent"]]["name"] in ("mp3tpu.encode.passA",
                                                 "mp3tpu.encode.passB")
        elif s["name"] == "mp3tpu.encode.labels":
            assert tree[s["parent"]]["name"] == "mp3tpu.encode.stage"
        elif s["name"].startswith("mp3tpu.encode."):
            assert s["parent"] == enc["id"]
        elif s["name"] in ("mp3tpu.scan", "mp3tpu.unpack"):
            assert tree[s["parent"]]["name"] == "mp3tpu.decode_files"
    assert "mp3tpu.d2h.wait" not in profiling.TOTALS   # nothing to the host


def test_outputs_are_the_same_with_recording_on_and_off(monkeypatch,
                                                        small_chunks):
    data = [clip_bytes("tonal")]
    pcms = short_pcms()

    def run():
        pcm = mp3tpu_torch.decode_batch(data, device="cpu")
        mp3s = mp3tpu_torch.encode_batch(pcms, SR, device="cpu")
        return pcm, mp3s, mp3tpu_torch.transcode_batch(mp3s, device="cpu")

    monkeypatch.delenv("MP3TPU_SPANS", raising=False)
    monkeypatch.delenv("MP3TPU_TRACE_DIR", raising=False)
    clear()
    off = run()
    assert not profiling.TOTALS
    monkeypatch.setenv("MP3TPU_SPANS", "1")
    on = run()
    assert profiling.TOTALS["mp3tpu.transcode_batch"]["count"] == 1
    monkeypatch.delenv("MP3TPU_SPANS")
    with profiling.request("mp3tpu.test_off"):
        pass
    clear()
    (pa, ra), = off[0]
    (pb, rb), = on[0]
    assert ra == rb and np.array_equal(pa, pb)
    assert off[1] == on[1] and off[2] == on[2]


@pytest.mark.cuda
def test_cuda_d2h_wait_spans_lie_on_the_device_trace(spans_on, tmp_path):
    """On the card, each mp3tpu.d2h.wait span of a traced decode_files
    lies within 0.5 ms of its record_function range (printed with -s)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from torch.profiler import ProfilerActivity, profile
    data = [clip_bytes(n) for n in ("sweep", "tonal", "transients")] * 4
    mp3tpu_torch.decode_batch(data, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        mp3tpu_torch.decode_batch(data, device="cuda")
        torch.cuda.synchronize()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = int(trace["baseTimeNanoseconds"])
    rid = spans("mp3tpu.decode_files")[-1]["request"]
    ours = [e for e in profiling.chrome_events(base)
            if e["name"] == "mp3tpu.d2h.wait" and e["args"]["request"] == rid]
    ranges = sorted((e for e in trace["traceEvents"]
                     if e.get("cat") == "user_annotation"
                     and e["name"] == "mp3tpu.d2h.wait"),
                    key=lambda e: e["ts"])
    assert len(ours) == len(ranges) >= 1
    offs = [(sp["ts"] - rf["ts"], sp["ts"] + sp["dur"] - rf["ts"] - rf["dur"])
            for rf, sp in zip(ranges, sorted(ours, key=lambda e: e["ts"]))]
    print(json.dumps({"d2h_wait_offsets_us": offs,
                      "card": torch.cuda.get_device_name(0)}))
    assert all(abs(a) < 500 and abs(b) < 500 for a, b in offs)
