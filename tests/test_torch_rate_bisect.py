"""The encoder's rate bisection kernel (csrc/rate_bisect.cu) behind
kernels/rate_bisect.py: inner_bisect and count_rows, the plain versions
vloop_device._inner_bisect and _count_rows.

On the CPU: the wrapper takes the plain versions and counts no launch; it
refuses what the kernel does not take; the kernel's gain scales are
_quantize's; its tables' layout, its bound, the sanitizer's cases; the plain
count on the cases' edge rows is vcount's at every sample rate; and the
benchmark's reader of the mp3tpu.encode.bisect spans. On the card (marked
cuda): the kernel against the plain versions on the sanitizer's cases, on
rows at and just over IX_MAX at the first gain searched, and on every call
the encoder makes for real streams, and encode_batch and transcode_batch
byte for byte against the plain loops. Imports no JAX.
"""
import os
import sys

import numpy as np
import pytest
import torch

import mp3tpu_torch
from mp3tpu_torch import sanitize
from mp3tpu_torch.encoder import vloop_device as vd
from mp3tpu_torch.encoder.quantize import GG_WINDOW, IX_MAX, MAGIC
from mp3tpu_torch.encoder.tables import encoder_tables
from mp3tpu_torch.encoder.vcount import count_bits_rows_full
from mp3tpu_torch.kernels import rate_bisect as rb
from mp3tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIPS = os.path.join(ROOT, "tests", "torch_clips")
SR = 44100


def spectra(n, seed, device="cpu"):
    """(p34, sign, budgets, lo0) of sanitize.rate_spectra's rows."""
    arrs = sanitize.rate_spectra(np.random.default_rng(seed), n)
    return tuple(torch.from_numpy(a).to(device) for a in arrs)


@pytest.fixture
def spans(monkeypatch):
    """Span recording on, TOTALS empty; yields TOTALS."""
    monkeypatch.setenv("MP3TPU_SPANS", "1")
    monkeypatch.setattr(profiling, "_ON", profiling._ON)
    saved = dict(profiling.TOTALS)
    profiling.TOTALS.clear()
    yield profiling.TOTALS
    profiling.TOTALS.clear()
    profiling.TOTALS.update(saved)


@pytest.mark.parametrize("short", [False, True])
@pytest.mark.parametrize("window", [None, GG_WINDOW])
def test_the_cpu_takes_the_plain_versions(short, window, spans):
    """On CPU tensors inner_bisect and count_rows give the plain versions'
    outputs, launch nothing, and each inner_bisect is a span with its rows
    and the outcome plain."""
    t = encoder_tables(SR, "cpu")
    p34, sign, budgets, lo0 = spectra(12, seed=1)
    before = (rb.inner_bisect.launches, rb.count_rows.launches)
    with profiling.request("test"):
        got = rb.inner_bisect(t, p34, sign, budgets, lo0, short, window)
    want = vd._inner_bisect(t, p34, sign, budgets, lo0, short, window)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [o.dtype for o in got] == [torch.int32, torch.bool, torch.bool,
                                      torch.int32]
    ix = vd._quantize(p34, sign, got[0])
    counted = rb.count_rows(t, ix, short)
    assert all(torch.equal(a, b)
               for a, b in zip(counted, vd._count_rows(t, ix, short)))
    assert (rb.inner_bisect.launches, rb.count_rows.launches) == before
    assert spans["mp3tpu.encode.bisect/plain"]["items"] == p34.shape[0]
    assert spans["mp3tpu.encode.bisect/plain"]["count"] == 1
    assert "mp3tpu.encode.bisect/kernel" not in spans


def test_the_loops_bisect_through_the_wrapper(spans):
    """Every bisection of the outer loops is a span of the wrapper: rows
    each outer iteration, plus the fallback's."""
    rng = np.random.default_rng(3)
    xr = (rng.standard_normal((9, 576)) * np.exp(-np.arange(576) / 120)
          ).astype(np.float32)
    xmin = np.full((9, 21), 1e-3, np.float32)
    with profiling.request("test"):
        vd.outer_rows_gathered_pending(torch.from_numpy(xr),
                                       torch.from_numpy(xmin), np.arange(9),
                                       np.full(9, 1500), SR)
    tot = spans["mp3tpu.encode.bisect/plain"]
    assert tot["count"] >= 1 and tot["items"] == 9 * tot["count"]


def test_wrapper_checks():
    t = encoder_tables(SR, "cpu")
    p34, sign, budgets, lo0 = spectra(4, seed=2)
    ok = dict(t=t, p34=p34, sign=sign, budgets=budgets, lo0=lo0,
              short_split=False)
    bad = [
        dict(p34=p34.double()), dict(sign=sign.long()),
        dict(budgets=budgets.long()), dict(lo0=lo0.to(torch.int16)),
        dict(p34=p34[:, :575].contiguous()), dict(sign=sign[:3]),
        dict(budgets=budgets[:3]), dict(lo0=lo0[None]),
        dict(p34=torch.cat([p34, p34], 1)[:, ::2]),
        dict(sign=sign.t().contiguous().t()),
        dict(budgets=torch.stack([budgets, budgets], 1)[:, 0]),
        dict(p34=p34.to("meta"), sign=sign.to("meta")),
        dict(budgets=budgets.to("meta")),
        dict(window=0), dict(window=257),
    ]
    assert rb.inner_bisect(**ok)[0].shape == (p34.shape[0],)
    for change in bad:
        with pytest.raises(ValueError):
            rb.inner_bisect(**{**ok, **change})
    ix = torch.zeros((3, 576), dtype=torch.int32)
    assert rb.count_rows(t, ix, False)[1].shape == (3, 3)
    for wrong in (ix.to(torch.int16), ix[:, :575].contiguous(),
                  torch.zeros((3, 1152), dtype=torch.int32)[:, ::2],
                  ix.to("meta"), ix[0]):
        with pytest.raises(ValueError):
            rb.count_rows(t, wrong, False)


def test_gain_scales_are_quantizes_expression():
    """The kernel's 256 scales are _quantize's expression at every gain, and
    given its scale _quantize's integers are floor(p34 * scale + MAGIC as
    float32): what the kernel computes (on the card the scales of both do
    not depend on the tensor's shape: test_gain_scales_on_card), on rows
    with lines on both sides of IX_MAX's rounding edges."""
    scale = rb.gain_scale(torch.device("cpu"))
    g = torch.arange(256, dtype=torch.int32)
    assert torch.equal(scale, torch.exp2(-0.75 * (g.float() - 210.0) / 4.0))
    p34, sign, _b, _l = spectra(6, seed=4)
    edges = [v for gg in (0, 99, 210, 255) for v in sanitize.ix_max_edge(gg)]
    p34[-1, :len(edges)] = torch.tensor(edges)
    sign[-1, :len(edges)] = 1
    magic = torch.tensor(MAGIC, dtype=torch.float32)
    for gg in range(256):
        gv = torch.full((p34.shape[0],), gg, dtype=torch.int32)
        s = torch.exp2(-0.75 * (gv[:, None].float() - 210.0) / 4.0)
        q = torch.floor(p34 * s + magic).to(torch.int32)
        assert torch.equal(vd._quantize(p34, sign, gv), sign * q)
    for gg in (0, 99, 210, 255):
        at, over = sanitize.ix_max_edge(gg)
        for v, want in ((at, IX_MAX), (over, IX_MAX + 1)):
            x = torch.tensor(v, dtype=torch.float32)
            assert int(torch.floor(x * scale[gg] + magic)) == want


@pytest.mark.parametrize("sr", [32000, 44100, 22050])
def test_count_consts_layout(sr):
    """The int32 vector the kernel reads: lengths [289, 32] with a zero last
    column, r1p, r2p, count1's two tables, a rule a column, the gain scales
    and MAGIC as float32 bits; made once per EncoderTables."""
    t = encoder_tables(sr, "cpu")
    c = rb.count_consts(t)
    assert c.dtype == torch.int32 and c.shape == (rb.CONSTS_WORDS,)
    assert rb.count_consts(t) is c
    lens = c[:289 * 32].reshape(289, 32)
    assert torch.equal(lens[:, :31], t.m_len) and not lens[:, 31].any()
    assert int(t.m_len.max()) < 256            # the kernel keeps them as uint8
    at = 289 * 32
    for want in (t.r1p, t.r2p, t.c1a_sig, t.c1b_sig):
        assert torch.equal(c[at:at + len(want)], want)
        at += len(want)
    rule = c[at:at + 32]
    assert torch.equal(rule[:30], torch.where(t.is_esc, rb.ESC | t.linbits, t.xl))
    assert not rule[30:].any()
    assert int(t.xl.max()) < rb.ESC and int(t.linbits.max()) < 256
    at += 32
    assert torch.equal(c[at:at + 256].view(torch.float32), rb.gain_scale("cpu"))
    assert float(c[at + 256:].view(torch.float32)) == np.float32(MAGIC)
    # the walk's regions are in order at every bv
    assert bool((t.r1p <= t.r2p).all()) and bool(
        (t.r2p <= torch.arange(289, dtype=torch.int32)).all())


def test_bound():
    """The figures PERF.md quotes: a 32,768-row block bisected reads and
    writes 151,625,356 bytes (45.26 us at 3.35 TB/s) and counted 76,455,564
    bytes (22.82 us); its lookups, at 150 pairs a counted step over 8
    steps, are 1,218,969,600 (145.75 us at 132 SMs x 32 a cycle x 1,980
    MHz), so the lookups bound it; 288 x 31 a row-step at most."""
    consts = 4 * rb.CONSTS_WORDS
    assert rb.CONSTS_WORDS == 289 * 32 + 2 * 289 + 32 + 32 + 256 + 1 == 10147
    b = rb.bound(32768, 32768 * 8 * 150, 1980.0)
    assert b["bytes"] == 32768 * (2 * 2304 + 18) + consts == 151625356
    assert b["lookups"] == 32768 * 8 * 150 * 31 == 1218969600
    assert b["bound_by"] == "operations"
    assert b["bound_us"] == pytest.approx(1218969600 / (132 * 32 * 1980e6) * 1e6)
    assert b["bound_us"] == pytest.approx(145.75, abs=0.005)
    assert 1e6 * b["bytes"] / 3.35e12 == pytest.approx(45.26, abs=0.005)
    c = rb.bound(32768, 0, 1980.0, count_only=True)
    assert c["bytes"] == 32768 * (2304 + 28) + consts == 76455564
    assert c["bound_by"] == "bytes"
    assert c["bound_us"] == pytest.approx(22.82, abs=0.005)
    assert rb.bound(1, 288 * 8, 1980.0)["lookups"] == 288 * 31 * 8


def test_sanitizer_cases():
    """sanitize.py's rate cases, the one list the card's checks run: every
    rate of the tables, both splits, the count and both bisections on 64
    random rows and the edge rows; then 1, 7, 33 and a grid's rows, one
    less and one more."""
    width = 40
    cases = list(sanitize.rate_cases("cpu", width))
    rates = sanitize.rate_rates()
    assert rates == [8000, 11025, 12000, 16000, 22050, 24000, 32000, 44100,
                     48000]
    assert len(cases) == len(rates) * 2 * 3 + 6 * 3
    assert {c[1] for c in cases} == set(rates)
    assert {c[2] for c in cases} == {"count", "full", "window"}
    tail = [int(c[0].split()[-2]) for c in cases[len(rates) * 6:]]
    assert sorted(set(tail)) == [1, 7, 33, width - 1, width, width + 1]
    for label, _sr, mode, args in cases:
        assert args[0].shape[0] == int(label.split()[-2])
        assert all(a.is_contiguous() for a in args[:-1])
    assert "rate_bisect" in sanitize.GROUPS and "rate_bisect" in sanitize.RUNNERS
    for dt in (torch.int32, torch.bool):
        buf, out = sanitize.guarded((5,), "cpu", dt)
        out.copy_(torch.ones(5, dtype=dt))
        sanitize.check_guards(buf, 5, str(dt))
        buf[sanitize.GUARD + 5] = 0
        with pytest.raises(AssertionError, match="outside"):
            sanitize.check_guards(buf, 5, str(dt))


def test_edge_rows_cover_every_region_empty():
    """rate_ix_rows' edge rows: bv 0 and 288, every even bv between; at each
    rate and split a row with each region empty; rows at and over IX_MAX."""
    ix = torch.from_numpy(sanitize.rate_ix_rows(np.random.default_rng(0), 0))
    _a, _b, bv, _k = vd.split_spectrum(ix)
    assert set(bv.tolist()) >= set(range(0, 289, 2))
    assert int(ix.abs().max()) == IX_MAX + 1
    for sr in sanitize.rate_rates():
        t = encoder_tables(sr, "cpu")
        for r1, r2 in ((t.r1p[bv.long()], t.r2p[bv.long()]),
                       (torch.clamp(bv, max=t.fixed_pairs), bv)):
            assert bool((r1 == 0).any()) and bool((r1 == r2).any())
            assert bool((r2 == bv).any()) and bool((r1 > 0).any())


@pytest.mark.parametrize("sr", [44100, 48000, 32000])
def test_plain_count_is_vcount_on_the_edge_rows(sr):
    """The kernel's reference on the cases' count rows at the encoder's
    rates (MPEG-1): the plain count's bits and tables are vcount's (the
    numpy count held to the scalar one), rows over IX_MAX aside."""
    from mp3tpu_torch.encoder.vcount import TABLE_IDS
    ix = sanitize.rate_ix_rows(np.random.default_rng(5), 16)
    ix = ix[np.abs(ix).max(1) <= IX_MAX]
    t = encoder_tables(sr, "cpu")
    for short, bt in ((False, 0), (True, 2)):
        bits, selr, _bv, _k, c1 = vd._count_rows(t, torch.from_numpy(ix), short)
        ref, sel = count_bits_rows_full(ix, sr, bt)
        assert np.array_equal(bits.numpy(), ref)
        tsel = np.stack([sel["t0"], sel["t1"], sel["t2"]], 1)
        assert np.array_equal(np.asarray(TABLE_IDS)[selr.numpy()], tsel)
        assert np.array_equal(c1.numpy(), sel["c1table"])


def bench_metric(name):
    bench = os.path.join(ROOT, "benchmark")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    from mp3bench import spec
    return spec.load_metric(name)


@pytest.mark.parametrize("name", ["encode.bisect_kernel_share.encode",
                                  "encode.bisect_kernel_share.transcode"])
def test_bisect_kernel_share_reads_the_spans(name):
    """Items of mp3tpu.encode.bisect/kernel over both outcomes' items, in
    percent: 100 when every row went through the kernel, 0 when none did,
    None without the span (a program that has none) or without a window."""
    from types import SimpleNamespace
    r = bench_metric(name)
    tot = lambda items: {"count": 3, "total_s": 0.1, "self_s": 0.1,
                         "items": items}
    ctx = lambda last: SimpleNamespace(probe=SimpleNamespace(
        snapshots={} if last is None else {"spans": [{}, last]}))
    kernel = {"mp3tpu.encode.bisect/kernel": tot(98304)}
    plain = {"mp3tpu.encode.bisect/plain": tot(512)}
    assert r.read(ctx(kernel)) == 100.0
    assert r.read(ctx(plain)) == 0.0
    assert r.read(ctx({**kernel, **plain})) == pytest.approx(
        100 * 98304 / (98304 + 512))
    assert r.read(ctx({"mp3tpu.encode.passA": tot(0)})) is None
    assert r.read(ctx({})) is None
    assert r.read(ctx(None)) is None


# ------------------------------------------------------------------ the card

def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Every case of sanitize.rate_cases around the card's persistent grid:
    launched three times into guarded outputs, bit-identical, and equal
    output for output to the plain versions."""
    need_card()
    recs = sanitize.run_rate("cuda")
    assert len(recs) == len(sanitize.rate_rates()) * 6 + 18
    assert all(r["max_abs_err"] == 0 for r in recs)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, GG_WINDOW])
def test_ix_max_edge_on_card(window, monkeypatch):
    """With the closed-form start left out (so the search starts at the
    gain itself), rows whose line quantizes to IX_MAX or one over it at that
    gain: the over test decides, the same on the card as in the plain
    version: the rows at IX_MAX take that gain and the rows over it the
    next."""
    need_card()
    monkeypatch.setattr(vd, "_bisect_lo", lambda p34, lo0: lo0)
    rows, gains = [], []
    for g in (0, 37, 150, 210, 254):
        for v in sanitize.ix_max_edge(g, "cuda"):
            for line in (0, 300, 575):
                r = np.zeros(576, np.float32)
                r[line] = v
                rows.append(r)
                gains.append(g)
    p34 = torch.from_numpy(np.stack(rows)).cuda()
    sign = (p34 > 0).to(torch.int32)
    budgets = torch.full((len(rows),), 100000, dtype=torch.int32, device="cuda")
    lo0 = torch.tensor(gains, dtype=torch.int32, device="cuda")
    t = encoder_tables(SR, "cuda")
    for short in (False, True):
        got = rb.inner_bisect(t, p34, sign, budgets, lo0, short, window)
        want = vd._inner_bisect(t, p34, sign, budgets, lo0, short, window)
        for i, (a, b) in enumerate(zip(got, want)):
            assert torch.equal(a, b), (i, a.tolist(), b.tolist())
        over = torch.tensor([i % 6 >= 3 for i in range(len(rows))],
                            device="cuda")
        assert got[0].tolist() == (lo0 + over.to(torch.int32)).tolist()


@pytest.mark.cuda
def test_gain_scales_on_card():
    """On the card _quantize's per-row scales equal the kernel's table at
    every gain, whatever the rows' number and position."""
    need_card()
    scale = rb.gain_scale(torch.device("cuda", torch.cuda.current_device()))
    for rows in (1, 29, 32768):
        for g in range(256):
            gv = torch.full((rows,), g, dtype=torch.int32, device="cuda")
            s = torch.exp2(-0.75 * (gv[:, None].float() - 210.0) / 4.0)
            assert bool((s[:, 0] == scale[g]).all()), (rows, g)


def corpus_pcms(seconds=4.0):
    """The three 10 s clips of tests/torch_clips decoded on the card, cut to
    `seconds`, as int16-origin float PCM."""
    paths = [os.path.join(CLIPS, f"{n}.mp3") for n in ("sweep", "transients",
                                                       "tonal")]
    out = mp3tpu_torch.decode_batch(paths, device="cuda")
    return paths, [pcm[:int(seconds * sr)].astype(np.float64) / 32768.0
                   for pcm, sr in out]


def plain_dispatch(monkeypatch):
    """Route the wrapper's CUDA calls to the plain versions."""
    monkeypatch.setattr(rb, "inner_bisect", lambda t, *a: vd._inner_bisect(t, *a))
    monkeypatch.setattr(rb, "count_rows", lambda t, *a: vd._count_rows(t, *a))


@pytest.mark.cuda
def test_encoder_calls_on_card(monkeypatch):
    """Every bisection and count encode_batch makes for the corpus clips
    (long, switched and short rows; full and windowed; the fallback), taken
    as the encoder hands them over: the kernel's outputs equal the plain
    versions' on the same tensors."""
    need_card()
    _paths, pcms = corpus_pcms()
    calls = []
    bisect, count = rb.inner_bisect, rb.count_rows

    def spy_bisect(t, p34, sign, budgets, lo0, short, window=None):
        calls.append(("bisect", t, (p34, sign, budgets, lo0, short, window)))
        return bisect(t, p34, sign, budgets, lo0, short, window)

    def spy_count(t, ix, short):
        calls.append(("count", t, (ix, short)))
        return count(t, ix, short)

    monkeypatch.setattr(rb, "inner_bisect", spy_bisect)
    monkeypatch.setattr(rb, "count_rows", spy_count)
    mp3tpu_torch.encode_batch(pcms, SR, bitrate=128, device="cuda")
    monkeypatch.undo()
    kinds = {(k, a[-1] if k == "bisect" else None, a[-2] if k == "bisect"
              else a[-1]) for k, _t, a in calls}
    assert ("bisect", None, False) in kinds and ("bisect", GG_WINDOW, False) in kinds
    assert ("count", None, True) in kinds        # switched or short rows
    n0 = rb.inner_bisect.launches
    for kind, t, args in calls:
        if kind == "bisect":
            got = rb.inner_bisect(t, *args)
            want = vd._inner_bisect(t, *args)
        else:
            got = rb.count_rows(t, *args)
            want = vd._count_rows(t, *args)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), kind
    assert rb.inner_bisect.launches - n0 == sum(
        k == "bisect" and a[0].shape[0] > 0 for k, _t, a in calls)


@pytest.mark.cuda
def test_bytes_equal_the_plain_loops_on_card(monkeypatch):
    """encode_batch of the corpus clips and transcode_batch of the clips to
    96 kbps: the same MP3 bytes through the kernel as through the plain
    loops on the card."""
    need_card()
    paths, pcms = corpus_pcms()
    n0 = (rb.inner_bisect.launches, rb.count_rows.launches)
    enc = mp3tpu_torch.encode_batch(pcms, SR, bitrate=128, device="cuda")
    tra = mp3tpu_torch.transcode_batch(paths, bitrate=96, device="cuda")
    assert rb.inner_bisect.launches > n0[0] and rb.count_rows.launches > n0[1]
    plain_dispatch(monkeypatch)
    assert [bytes(b) for b in enc] == [bytes(b) for b in mp3tpu_torch.encode_batch(
        pcms, SR, bitrate=128, device="cuda")]
    assert [bytes(b) for b in tra] == [bytes(b) for b in mp3tpu_torch.transcode_batch(
        paths, bitrate=96, device="cuda")]
