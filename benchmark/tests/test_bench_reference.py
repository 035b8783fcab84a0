"""The plain reference against the program's own float64 oracle, the
program's int16 contract against the reference, and the controls: the
reference one precision below (TF32) fails the decode's limits, the
program one bitrate below fails the encode's audit, and the transcode's
control fails both halves."""
import numpy as np
import pytest

from conftest import ROOT


def clip(config, name):
    with open(f"{ROOT}/benchmark/corpus/{config}/{name}.mp3", "rb") as f:
        return f.read()


@pytest.mark.parametrize("config,name", [("cbr128", "piano"),
                                         ("cbr320", "transients")])
def test_the_granule_chain_is_the_oracles(config, name):
    from mp3bench import reference
    from mp3tpu_torch.oracle.decoder import decode_symbols
    from mp3tpu_torch.pipeline import load_symbols
    st, _ = reference.load(clip(config, name))
    got = reference.dsp.granule_chain(st.slice_granules(0, 120)).numpy()
    st2, _, _ = load_symbols(clip(config, name))
    want = decode_symbols(st2.slice_granules(0, 120))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_the_programs_decode_keeps_its_contract():
    import mp3tpu_torch as m
    from mp3bench import reference
    from mp3bench.checks import decode_numbers
    data = clip("cbr128", "mix")
    want, rate = reference.decode(data)
    got = m.decode_batch([data], device="cpu")[0]
    n = decode_numbers([(got, want, rate)])
    assert n["streams_off"] == 0 and n["max_lsb"] <= 1 and n["inexact_pct"] <= 2.0


@pytest.mark.parametrize("config,name", [("cbr128", "speech"),
                                         ("cbr320", "chord")])
def test_the_decode_control_fails(config, name):
    """The reference at TF32 in the program's place, on a whole corpus clip:
    outside both of the configuration's limits."""
    from mp3bench import reference, spec
    from mp3bench.checks import decode_numbers, verdict
    data = clip(config, name)
    want, rate = reference.decode(data)
    ctrl, _ = reference.decode(data, "tf32")
    n = decode_numbers([((ctrl, rate), want, rate)])
    cfg = spec.load_json(f"{ROOT}/benchmark/configs/{config}.json")
    assert n["max_lsb"] > cfg["limits"]["max_lsb"]
    assert n["inexact_pct"] > cfg["limits"]["inexact_pct"]
    assert not verdict(n, cfg["limits"])[0]


def test_the_encode_control_fails_and_the_program_passes():
    import mp3tpu_torch as m
    from mp3bench import signals
    from mp3bench.checks import encoded_numbers
    from mp3bench.entries.encode_batch import lower_bitrate
    fmt = {"sample_rate": 44100, "frame_modes": ["stereo", "joint_stereo"]}
    x = [signals.make(k, 1.0, 3) for k in ("noise", "piano")]
    ok = m.encode_batch(x, 44100, bitrate=128, device="cpu")
    low = m.encode_batch(x, 44100, bitrate=lower_bitrate(128), device="cpu")
    n_ok = encoded_numbers(list(zip(ok, x)), fmt, 128)
    n_low = encoded_numbers(list(zip(low, x)), fmt, 128)
    assert n_ok["header_off"] == n_ok["budget_off"] == n_ok["length_off"] == 0
    assert n_ok["worst_nsr"] < 0.5
    assert n_low["header_off"] > 0


def test_the_transcode_control_fails_both_halves(small):
    """transcode_batch's control, run as calibrate.py runs it: the TF32
    reference in the decode half's place is outside both of the
    configuration's limits, the program one bitrate below is off its
    headers."""
    import mp3tpu_torch as m
    from mp3bench import spec
    from mp3bench.checks import verdict
    cell = small("cbr320.rendition_transcode")
    entry = spec.load_entry(cell.entry)
    work = entry.prepare(cell, 2 ** 31 + 5)
    kept = entry.control([(0, 0, None), (1, 3, None)], work, cell, m, "cpu")
    n = entry.check(kept, work, cell)
    assert n["max_lsb"] > cell.limits["max_lsb"]
    assert n["inexact_pct"] > cell.limits["inexact_pct"]
    assert n["header_off"] > 0 and n["streams_off"] == 0
    assert not verdict(n, cell.limits)[0]
