"""The port's device encoder modules (src/mp3tpu_torch/encoder/: tables,
device, psy_device, vloop_device, emit_device) held against the JAX package's
on the CPU, on the same numpy inputs made from a seed.

Exact (integers): the tables, the bit count, the emitter, the row gather and
the block-type labels. Close (float32): the transform, psychoacoustic model 2
and the three loops, each with its tolerance stated where it is held.
"""
import numpy as np
import pytest
import torch

import fixtures
import jax.numpy as jnp
from mp3tpu.encoder import device as jdev
from mp3tpu.encoder import emit_device as jemit
from mp3tpu.encoder import psy_device as jpsy
from mp3tpu.encoder import vloop_device as jvd
from mp3tpu.encoder.psymodel import get_model as jax_get_model
from mp3tpu_torch.encoder import device as tdev
from mp3tpu_torch.encoder import emit_device as temit
from mp3tpu_torch.encoder import native_emit, psy_device as tpsy
from mp3tpu_torch.encoder import tables as ttab
from mp3tpu_torch.encoder import vloop, vloop_device as tvd
from mp3tpu_torch.encoder.huffcode import encode_granule
from mp3tpu_torch.encoder.psymodel import (MDCT_ALIGN, align_to_mdct,
                                           block_type_sequence,
                                           block_types_from_subblock_energy)
from mp3tpu_torch.encoder.transform import granule_spectra
from mp3tpu_torch.encoder.vcount import (TABLE_IDS, count_bits_rows,
                                         count_bits_rows_full)

torch.set_num_threads(1)
SR = 44100
COL_OF = {tid: col for col, tid in enumerate(TABLE_IDS)}
LAYOUT_BT = {"long": 0, "switched": 1, "short": 2}


def jax_tables_numpy(sr: int) -> dict:
    """The JAX package's constants as numpy, under EncoderTables' names."""
    A, fmats, post, inv = jdev._consts(sr)
    m = jax_get_model(sr)
    C = jvd._device_consts(sr)
    E = jemit._emit_consts(sr)
    n = lambda a: np.asarray(a)
    return dict(
        analysis_fir=n(A), mdct=n(fmats), post=n(post), inv_mask=n(inv),
        red_l=m.red_l, spread_l=m.spread_l, red_s=m.red_s,
        spread_s=m.spread_s, minval_l=m.minval_l, qthr_l=m.qthr_l,
        qthr_s=m.qthr_s, w_l=m.w_l, w_s12=m.w_s[:, :12], win_l=m.win_l,
        win_s=m.win_s,
        m_len=n(C["M_len"]), xl=n(C["xl"]), linbits=n(C["linbits"]),
        is_esc=n(C["is_esc"]), r1p=n(C["r1p"]), r2p=n(C["r2p"]),
        band_of_line=n(C["band_of_line"]), wline=n(C["wline"]),
        sline=n(C["sline"]), c1a_sig=n(C["c1a_sig"]), c1b_sig=n(C["c1b_sig"]),
        slen1=n(C["slen1"]), slen2=n(C["slen2"]),
        lut=n(E["lut"]), c1a=n(E["c1a"]), emit_linbits=n(E["linbits"]),
        esc16=n(E["esc16"]), emit_r1p=n(E["r1p"]), emit_r2p=n(E["r2p"]),
        r0c_t=n(E["r0c_t"]), r1c_t=n(E["r1c_t"]))


@pytest.mark.parametrize("sr", [44100, 48000, 32000])
def test_tables_equal_the_jax_packages(sr):
    """Every field of the port's own tables equals the JAX package's
    constant: integers exactly, floats after the same float32 rounding."""
    own = ttab.encoder_tables(sr, "cpu")
    theirs = ttab.encoder_tables_from_numpy(jax_tables_numpy(sr), sr, "cpu")
    for name, _dtype in ttab.FIELDS:
        assert torch.equal(getattr(own, name), getattr(theirs, name)), name
    assert torch.equal(own.long_lines, theirs.long_lines)
    assert torch.equal(own.short_lines, theirs.short_lines)
    assert own.fixed_pairs == int(jemit._emit_consts(sr)["fixed_pairs"])


def test_band_sums_are_the_one_hot_products():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 576)) ** 2
    t = ttab.encoder_tables(SR, "cpu")
    C = jvd._device_consts(SR)
    got_l = ttab.band_sums(torch.as_tensor(x), t.long_lines).numpy()
    got_s = ttab.band_sums(torch.as_tensor(x), t.short_lines).numpy()
    np.testing.assert_allclose(got_l, (x @ np.asarray(C["ind21"], np.float64))[:, :21],
                               rtol=1e-12)
    np.testing.assert_allclose(got_s, x @ np.asarray(C["ind39"], np.float64),
                               rtol=1e-12)


# ---- the bit count: exact

def _count_rows_np(ix, short):
    t = ttab.encoder_tables(SR, "cpu")
    out = tvd._count_rows(t, torch.as_tensor(ix), short)
    return [o.numpy() for o in out]


def _spread_rows(rng, n):
    ix = np.zeros((n, 576), np.int32)
    for r in range(n):
        k = rng.integers(50, 400)
        pos = rng.choice(576, k, replace=False)
        ix[r, pos] = np.round(rng.standard_normal(k) *
                              rng.choice([1, 2, 5, 30, 200])).astype(np.int32)
    ix[0] = 0                                   # silence
    ix[1, :8] = [1, -1, 0, 1, -1, 0, 0, 1]      # count1 only
    ix[1, 8:] = 0
    ix[2, :2] = (8191 + 15, -(8191 + 15))       # the deepest escape
    ix[2, 2:] = 0
    ix[3] = 1                                   # every tie in count1
    return ix


@pytest.mark.parametrize("short", [False, True])
def test_count_rows_exact(short):
    """bits, the three table columns, bv, k and c1sel equal the JAX count's
    and vcount's on the same ix, integer for integer."""
    ix = _spread_rows(np.random.default_rng(0), 48)
    bits, selr, bv, k, c1 = _count_rows_np(ix, short)
    jb, jselr, jbv, jk, jc1 = jvd._count_rows(
        jnp, jvd._device_consts(SR), jnp.asarray(ix), short)
    assert np.array_equal(bits, np.asarray(jb))
    assert np.array_equal(selr, np.asarray(jselr))
    assert np.array_equal(bv, np.asarray(jbv))
    assert np.array_equal(k, np.asarray(jk))
    assert np.array_equal(c1, np.asarray(jc1))
    ref, sel = count_bits_rows_full(ix, SR, 2 if short else 0)
    assert np.array_equal(bits, ref)
    assert np.array_equal(tvd._TID[selr],
                          np.stack([sel["t0"], sel["t1"], sel["t2"]], 1))
    assert np.array_equal(c1, sel["c1table"])


def test_first_min_takes_the_lowest_index():
    cost = torch.tensor([[5, 3, 3, 9], [7, 7, 7, 7], [1 << 20, 2, 1 << 20, 2]],
                        dtype=torch.int32)
    val, idx = tvd.first_min(cost)
    assert val.tolist() == [3, 7, 2] and idx.tolist() == [1, 0, 1]


# ---- the emitter: exact

def _rand_rows(rng, n, scale=30, tail=None):
    """Spectra shaped like rate-loop output: decaying magnitudes, a
    quad-aligned count1 stretch, an rzero tail."""
    rows = np.zeros((n, 576), np.int32)
    for i in range(n):
        live = tail if tail is not None else int(rng.integers(8, 560))
        mag = (rng.standard_normal(live)
               * scale * np.exp(-3.0 * np.arange(live) / max(live, 1)))
        rows[i, :live] = np.rint(mag).astype(np.int32)
        c1 = int(rng.integers(0, 60)) * 4
        lo = max(live - c1, 0)
        rows[i, lo:live] = rng.integers(-1, 2, live - lo)
    return rows


def _emit_case(name):
    """(rows, layout, use_sf, long sf, short sf) of one emitter case (the
    cases of tests/test_emit_device.py)."""
    seed = ["long_plain", "long_escapes", "long_sf", "switched_sf",
            "switched_plain", "short_sf", "short_plain", "degenerate"].index(name)
    rng = np.random.default_rng(seed)
    if name == "long_plain":
        return _rand_rows(rng, 24, scale=8), "long", False, None, None
    if name == "long_escapes":
        rows = _rand_rows(rng, 24, scale=120)
        rows[0, 0:2] = (15, -15)          # boundary: esc field of value 0
        rows[1, 0:2] = (100, -2000)       # deep linbits
        return rows, "long", False, None, None
    if name == "long_sf":
        lsf = rng.integers(0, 8, (16, 21)).astype(np.int64)
        lsf[3] = 0                        # sf present but all zero: no part2
        return _rand_rows(rng, 16, scale=25), "long", True, lsf, None
    if name.startswith("switched"):
        lsf = rng.integers(0, 4, (12, 21)).astype(np.int64)
        sf = name.endswith("_sf")
        return (_rand_rows(rng, 12, scale=20), "switched", sf,
                lsf if sf else None, None)
    if name.startswith("short"):
        ssf = np.concatenate(
            [rng.integers(0, 16, (12, 3, 6)), rng.integers(0, 8, (12, 3, 6))],
            axis=2).astype(np.int64)
        sf = name.endswith("_sf")
        return (_rand_rows(rng, 12, scale=18), "short", sf, None,
                ssf if sf else None)
    rows = np.zeros((6, 576), np.int32)
    rows[1, :8] = [1, -1, 0, 1, -1, 0, 0, 1]       # count1 only
    rows[2, 0] = 3                                  # one big-values pair
    rows[3, 572:576] = [1, 0, -1, 1]                # tail quad
    rows[4, :2] = (8191 + 15, -(8191 + 15))         # max linbits-13 escape
    return rows, "long", False, None, None


@pytest.mark.parametrize("case", [
    "long_plain", "long_escapes", "long_sf", "switched_sf", "switched_plain",
    "short_sf", "short_plain", "degenerate"])
def test_emitter_exact(case):
    """words, nbits, bv, sfc, r0c, r1c equal the JAX emitter's on the same
    (ix, sf, tsel, c1sel), and the bytes equal huffcode.encode_granule's and
    the C++ row emitter's."""
    rows, layout, use_sf, lsf, ssf = _emit_case(case)
    bt = LAYOUT_BT[layout]
    n = len(rows)
    refs, gs = [], []
    for i in range(n):
        kw = {}
        if lsf is not None and lsf[i].any():
            kw["long_sf"] = lsf[i]
        if ssf is not None and ssf[i].any():
            kw["short_sf"] = ssf[i]
        g = encode_granule(rows[i], 210, SR, bt, **kw)
        row = np.packbits(np.asarray(g.bits.bits, np.uint8))
        ref = np.zeros(temit.CAP_WORDS * 4, np.uint8)
        ref[: len(row)] = row
        refs.append(ref)
        gs.append(g)
    tsel = np.array([[COL_OF[t] for t in g.table_select] for g in gs], np.int32)
    c1 = np.array([g.count1table_select for g in gs], np.int32)
    if layout == "short":
        sf = np.zeros((n, 3, 12), np.int32) if ssf is None else ssf.astype(np.int32)
    else:
        sf = np.zeros((n, 21), np.int32) if lsf is None else lsf.astype(np.int32)
    words, meta = temit.emit_rows_device(rows, sf, tsel, c1, SR, layout,
                                         use_sf, device="cpu")
    jwords, jmeta = jemit.emit_rows_device(rows, sf, tsel, c1, SR, layout,
                                           use_sf)
    assert np.array_equal(words.numpy().astype(np.uint32),
                          np.asarray(jwords, np.uint32))
    assert np.array_equal(meta.numpy(), np.asarray(jmeta))
    got = temit.words_to_bytes(words).numpy()
    assert np.array_equal(got, temit.words_to_bytes(words.numpy()))
    assert np.array_equal(got, jemit.words_to_bytes(np.asarray(jwords)))
    meta = meta.numpy()
    for i, g in enumerate(gs):
        assert np.array_equal(got[i], refs[i]), i
        assert tuple(meta[i]) == (g.part2_3_length, g.big_values,
                                  g.scalefac_compress, g.region0_count,
                                  g.region1_count), i
    # the C++ row emitter on the same rows
    packed = native_emit.encode_rows_packed(
        rows, np.full(n, bt), np.full(n, use_sf),
        np.zeros((n, 21), np.int64) if lsf is None else lsf,
        np.zeros((n, 3, 12), np.int64) if ssf is None else ssf,
        tvd._TID[tsel], c1, SR)
    assert packed is not None
    assert np.array_equal(packed[0], got)
    assert np.array_equal(packed[1][:, :5], meta)


# ---- gather and staging: exact

def test_gather_rows_and_subblock_energy():
    rng = np.random.default_rng(3)
    chunk = rng.integers(-32768, 32768, (3, 5000, 2)).astype(np.int16)
    rows, skips, lens, T = [2, 0], [1105, 0], [3000, 4990], 8 * 576
    for nch in (1, 2):
        got = tdev.gather_rows(torch.from_numpy(chunk), rows, skips, lens, T, nch)
        want = jdev._gather_rows_jit(T, nch)(
            jnp.asarray(chunk), jnp.asarray(rows, jnp.int32),
            jnp.asarray(skips, jnp.int32), jnp.asarray(lens, jnp.int32))
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert got.shape == (2, nch, T)
        k = np.arange(3000)
        assert np.array_equal(got[0, 0, :3000].numpy(),
                              chunk[2, 1105 + k, 0].astype(np.float32) / 32768.0)
        assert not got[0, :, 3000:].any()
    # sub-block energies: float32 sums of 64 squares, summed in another order
    e = tdev.subblock_energy(got, MDCT_ALIGN).numpy()
    je = np.asarray(jdev._subblock_energy_jit(MDCT_ALIGN)(jnp.asarray(got.numpy())))
    np.testing.assert_allclose(e, je, rtol=1e-5)


def test_stage_pcm_int16_origin():
    rng = np.random.default_rng(4)
    i16 = rng.integers(-32768, 32768, (3, 2304)).astype(np.int16)
    pcm = i16.astype(np.float32) / np.float32(32768.0)
    dev, staged = tdev.stage_pcm(pcm, "cpu")
    assert staged and np.array_equal(dev.numpy(), pcm)
    dev, staged = tdev.stage_pcm(pcm * np.float32(0.37), "cpu")
    assert not staged and np.array_equal(dev.numpy(), pcm * np.float32(0.37))


def test_block_types_from_device_energies():
    """The labels decided from the device's float32 sub-block energies equal
    the host's float64 labels on the transient clip."""
    sig = fixtures.transients(1.5, SR)
    i16 = np.round(sig * 32767).astype(np.int16)
    n = len(i16)
    G = -(-(n + 528 + 529) // 576)
    G += G & 1
    padded = np.zeros((G * 576, 2))
    padded[:n] = i16.astype(np.float64) / 32768.0
    want = block_type_sequence(align_to_mdct(padded), SR)
    grab = tdev.gather_rows(torch.from_numpy(i16[None]), [0], [0], [n],
                            G * 576, 2)
    e = tdev.subblock_energy(grab, MDCT_ALIGN).numpy().astype(np.float64)
    got = block_types_from_subblock_energy(e[0, : G * 9])
    assert np.array_equal(got, want)
    assert (got == 2).any()


# ---- transform and psymodel: close

def _pcm_and_types(rng, B=2, G=12):
    t = np.arange(G * 576) / SR
    pcm = np.stack([0.4 * np.sin(2 * np.pi * (300 + 200 * b) * t)
                    + 0.05 * rng.standard_normal(len(t)) for b in range(B)])
    pcm[0, 3000:3100] += 0.5 * rng.standard_normal(100)
    bts = np.zeros((B, G), np.int64)
    bts[0, 4:8] = [1, 2, 2, 3]
    return pcm, bts


def test_transform_close():
    """Spectra within 2e-6 of max |X| of the JAX transform's (both float32,
    other summation orders) and within 5e-6 of the float64 transform's."""
    pcm, bts = _pcm_and_types(np.random.default_rng(5))
    got = tdev.granule_spectra_device_batch(pcm, bts, SR, device="cpu")
    want = jdev.granule_spectra_device_batch(pcm, bts, SR)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2e-6 * scale
    ref = np.stack([granule_spectra(pcm[b], bts[b], SR) for b in range(2)])
    assert np.abs(got - ref).max() <= 5e-6 * scale
    one = tdev.granule_spectra_device(pcm[0], bts[0], SR, device="cpu")
    assert np.array_equal(one, got[0])


@pytest.mark.parametrize("align", [0, MDCT_ALIGN])
def test_psymodel_close(align):
    """ratio_l and ratio_s within 1e-3 relative of psy_device.analyze_batch's
    (float32 FFTs and atan2 of two libraries; the ratios span decades)."""
    pcm, bts = _pcm_and_types(np.random.default_rng(6))
    rl, rs = tpsy.analyze_batch(pcm, bts, SR, align=align, device="cpu")
    jl, js = jpsy.analyze_batch(pcm, bts, SR, align=align)
    assert rl.shape == jl.shape == (2, 12, 21)
    assert rs.shape == js.shape == (2, 12, 3, 12)
    np.testing.assert_allclose(rl, jl, rtol=1e-3)
    np.testing.assert_allclose(rs, js, rtol=1e-3)
    assert (rs[bts != 2] == 1e9).all()


# ---- the loops: close across packages, exact within the port

def _loop_rows(rng, R):
    xr = rng.standard_normal((R, 576)) * \
        np.exp(-np.arange(576) / 120)[None] * rng.uniform(0.01, 2.0, (R, 1))
    return xr.astype(np.float32), rng.integers(500, 3000, R).astype(np.int64)


def _check_contract(ix, bits, budgets, bt):
    """count == emit's first half: the reported bits are vcount's of the
    returned ix, and they fit the budget."""
    assert np.array_equal(bits, count_bits_rows(ix.astype(np.int32), SR, bt))
    assert (bits <= budgets).all()


@pytest.mark.parametrize("bt", [0, 2])
def test_rate_loop(bt):
    """gg within 1 of the JAX loop's and of the numpy lockstep loop's on the
    same rows (float32 flips at quantization boundaries); at least 95% of the
    rows with identical gg (measured 100% for both layouts: 48 rows, seed
    1)."""
    xr, budg = _loop_rows(np.random.default_rng(1), 48)
    gg, has, ix, bits, tsel, c1 = tvd.rate_rows_device(xr, budg, SR, bt,
                                                       device="cpu")
    assert has.all()
    _check_contract(ix, bits, budg, bt)
    jgg, _h, jix, jbits, jtsel, _c = jvd.rate_rows_device(xr, budg, SR, bt)
    assert np.abs(gg.astype(int) - jgg.astype(int)).max() <= 1
    assert (gg == jgg).mean() >= 0.95
    same = gg == jgg
    assert np.array_equal(ix[same], jix[same])
    assert np.array_equal(tsel[same], jtsel[same])
    _ix, gg_n = vloop.inner_rate_rows(xr.astype(np.float64), budg, SR, bt)
    assert np.abs(gg.astype(int) - gg_n).max() <= 1


def _xmin(rng, xr, shape):
    en = (xr.astype(np.float64) ** 2).sum(1) / 576
    return (en.reshape((-1,) + (1,) * len(shape))
            * rng.uniform(0.002, 0.5, (len(xr),) + shape)).astype(np.float32)


@pytest.mark.parametrize("block_type", [0, 1])
def test_outer_loop_long(block_type):
    """gg within 2 of the JAX loop's and at least 95% of the rows with
    identical (gg, sf) (measured 100% for both splits: 40 rows, seed 2)."""
    rng = np.random.default_rng(2)
    xr, budg = _loop_rows(rng, 40)
    xmin = _xmin(rng, xr, (21,))
    idx = np.arange(40)
    gg, sf, has, ix, bits, tsel, c1 = tvd.outer_rows_gathered(
        torch.as_tensor(xr), torch.as_tensor(xmin), idx, budg, SR,
        block_type=block_type)
    assert has.all() and sf.max() <= 15
    sfc = vloop.pick_sfc_rows(sf.astype(np.int64))
    _check_contract(ix, bits, budg - 11 * vloop._SLEN1[sfc]
                    - 10 * vloop._SLEN2[sfc], block_type)
    j = jvd.outer_rows_gathered(jnp.asarray(xr), jnp.asarray(xmin), idx, budg,
                                SR, block_type=block_type)
    assert np.abs(gg.astype(int) - j[0].astype(int)).max() <= 2
    same = (gg == j[0]) & (sf == j[1]).all(1)
    assert same.mean() >= 0.95
    assert np.array_equal(ix[same], j[3][same])
    assert np.array_equal(bits[same], j[4][same])


def test_outer_loop_short():
    """As the long loop: gg within 2, at least 95% identical (gg, sf, sbg)
    (measured 100%: 32 rows, seed 3)."""
    rng = np.random.default_rng(3)
    xr, budg = _loop_rows(rng, 32)
    xmin = _xmin(rng, xr, (3, 12))
    idx = np.arange(32)
    gg, sf, sbg, has, ix, bits, tsel, c1 = tvd.outer_rows_short_gathered(
        torch.as_tensor(xr), torch.as_tensor(xmin), idx, budg, SR)
    assert has.all() and sbg.max() <= 7
    sfc = vloop.pick_sfc_short_rows(sf.astype(np.int64))
    _check_contract(ix, bits, budg - 18 * (vloop._SLEN1[sfc]
                                           + vloop._SLEN2[sfc]), 2)
    j = jvd.outer_rows_short_gathered(jnp.asarray(xr), jnp.asarray(xmin), idx,
                                      budg, SR)
    assert np.abs(gg.astype(int) - j[0].astype(int)).max() <= 2
    same = (gg == j[0]) & (sf == j[1]).all((1, 2)) & (sbg == j[2]).all(1)
    assert same.mean() >= 0.95
    assert np.array_equal(ix[same], j[4][same])


def test_loops_do_not_depend_on_the_row_block(monkeypatch):
    """A row's result is the same in blocks of 7 rows as in one block."""
    rng = np.random.default_rng(7)
    xr, budg = _loop_rows(rng, 30)
    xl, xs = _xmin(rng, xr, (21,)), _xmin(rng, xr, (3, 12))
    idx = np.arange(30)

    def run():
        t = torch.as_tensor
        return (tvd.outer_rows_gathered(t(xr), t(xl), idx, budg, SR)
                + tvd.outer_rows_short_gathered(t(xr), t(xs), idx, budg, SR)
                + tvd.rate_rows_gathered(t(xr), idx, budg, SR, 0))

    whole = run()
    monkeypatch.setitem(tvd.ROW_BLOCK, "cpu", 7)
    for a, b in zip(whole, run()):
        assert np.array_equal(a, b)


def test_loop_rows_emit_to_their_count():
    """Rows the loops produced: the device emitter lands on the loop's own
    bit count and table selection, and on encode_granule's bytes."""
    rng = np.random.default_rng(5)
    xr, budg = _loop_rows(rng, 16)
    pend = tvd.rate_rows_gathered_pending(torch.as_tensor(xr), np.arange(16),
                                          budg, SR, 0)
    by, m5, gg, tcols, c1, hb, sbg = pend.emit_and_take("long", False,
                                                        np.arange(16))
    assert sbg is None and np.array_equal(m5[:, 0], hb)
    raw = pend.fetch_rows()
    for i in range(16):
        g = encode_granule(raw["ix"][i].astype(np.int32), int(gg[i]), SR, 0,
                           tsel=tuple(int(t) for t in tvd._TID[tcols[i]]),
                           c1table=int(c1[i]))
        assert g.part2_3_length == int(m5[i, 0])
        row = np.packbits(np.asarray(g.bits.bits, np.uint8))
        assert np.array_equal(by[i, : len(row)], row)
        assert not by[i, len(row):].any()
