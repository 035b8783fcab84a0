"""C1-C5 of the PyTorch port (kernels/fused_z.py) held against the JAX
package: the Pallas kernel _kernel_z in interpret mode, and the XLA path's
z. The CUDA kernel itself is held against the plain version on the card
(the cuda-marked tests: kernels/selfcheck.py's checks); here, on the CPU,
the coefficients it takes and that the checks' tolerance fails a wrong
kernel."""
import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mp3tpu.kernels import pallas_fused as pf
from mp3tpu.kernels import pipeline as kp
from mp3tpu_torch.kernels import fused_z as fz
from mp3tpu_torch.kernels import selfcheck
from mp3tpu_torch.kernels.tables import build_tables
from mp3tpu_torch.pipeline import load_symbols

# float32 both sides; the cube-root seed, the order of the two-term alias
# sums and of the 18-term IMDCT sums differ, each a few ulp of the largest z
Z_REL_TOL = 1e-5


def symbols(S: int, G: int, seed: int):
    """Seeded symbols covering every flavor and block type, mixed blocks,
    all 144 palette indices and escape-sized values."""
    rng = np.random.default_rng(seed)
    is_ = rng.integers(-15, 16, (S, G, 2, 576)).astype(np.int16)
    big = rng.random(is_.shape) < 0.01
    is_[big] = rng.integers(-8206, 8207, int(big.sum()))
    exp = rng.integers(-80, 8, (S, G, 2, 64)).astype(np.int16)
    bt = np.tile(np.arange(4, dtype=np.int8), S * G * 2 // 4 + 1)[:S * G * 2]
    bt = rng.permutation(bt).reshape(S, G, 2)
    mixed = (rng.random((S, G, 2)) < 0.5) & (bt == 2)
    smode = rng.integers(0, 144, (S, G, 64)).astype(np.uint8)
    smode.reshape(-1)[:144] = np.arange(144)
    return is_, exp, bt, mixed, smode


def port_z(args, sr=44100):
    return fz.fused_pipeline_z_reference(
        *(torch.from_numpy(a) for a in args), build_tables(sr, "cpu")).numpy()


def assert_close(got, want):
    scale = np.abs(want).max()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= Z_REL_TOL * scale


@pytest.mark.parametrize("sr", (44100, 22050))
def test_plain_matches_xla_z(sr, monkeypatch):
    args = symbols(2, 32, seed=sr)
    monkeypatch.setattr(kp, "_backend", lambda z, state, tables, S, G: (z, state))
    want, _ = kp._granule_pipeline_xla(*(jnp.asarray(a) for a in args),
                                       kp.init_state(2), kp.build_tables(sr))
    assert_close(port_z(args, sr), np.asarray(want))


def test_plain_matches_pallas_kernel_z(monkeypatch):
    """_kernel_z itself, in Pallas interpret mode on the JAX CPU backend."""
    monkeypatch.setattr(pf.pl, "pallas_call",
                        functools.partial(pf.pl.pallas_call, interpret=True))
    args = symbols(1, 32, seed=7)
    want = pf.fused_pipeline_z(*(jnp.asarray(a) for a in args),
                               kp.build_tables(44100), 44100)
    assert_close(port_z(args), np.asarray(want))


def test_wrapper_runs_plain_on_cpu():
    args = [torch.from_numpy(a) for a in symbols(1, 4, seed=3)]
    t = build_tables(44100, "cpu")
    before = fz.fused_pipeline_z.launches
    z = fz.fused_pipeline_z(*args, t)
    assert fz.fused_pipeline_z.launches == before  # no kernel on the CPU
    assert torch.equal(z, fz.fused_pipeline_z_reference(*args, t))
    # int32 symbols and uint8 mixed flags give the same z
    wide = [args[0].int(), args[1].int(), args[2].int(), args[3].to(torch.uint8),
            args[4]]
    assert torch.equal(fz.fused_pipeline_z(*wide, t), z)


def test_wrapper_checks_its_inputs():
    is_, exp, bt, mixed, smode = (torch.from_numpy(a) for a in symbols(1, 4, seed=4))
    t = build_tables(44100, "cpu")
    with pytest.raises(ValueError, match="exp: shape"):
        fz.fused_pipeline_z(is_, exp[..., :63], bt, mixed, smode, t)
    with pytest.raises(TypeError, match="is_: dtype"):
        fz.fused_pipeline_z(is_.float(), exp, bt, mixed, smode, t)
    with pytest.raises(TypeError, match="smode: dtype"):
        fz.fused_pipeline_z(is_, exp, bt, mixed, smode.int(), t)
    # no path hands over int16 spectrum with int32 exponents, and the
    # kernel has no instantiation for it
    with pytest.raises(TypeError, match="is_/exp: dtypes"):
        fz.fused_pipeline_z(is_, exp.int(), bt, mixed, smode, t)


@pytest.mark.cuda
@pytest.mark.parametrize("S", (64, 256))
def test_kernel_matches_plain_on_card(S):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = [torch.from_numpy(a).cuda() for a in symbols(S, 32, seed=S)]
    t = build_tables(44100, "cuda")
    before = fz.fused_pipeline_z.launches
    z = fz.fused_pipeline_z(*args, t)
    want = fz.fused_pipeline_z_reference(*args, t)
    torch.cuda.synchronize()
    assert fz.fused_pipeline_z.launches == before + 1
    selfcheck.compare("fused_z", z, want, f"S={S}")
    assert torch.equal(z, fz.fused_pipeline_z(*args, t))  # deterministic


def kernel_c5(v, coefs, b):
    """C5 of one subband as csrc/fused_z.cu computes it, from the 540
    coefficients it is given: the 18 distinct IMDCT-36 sums unfolded by
    symmetry and windowed (long), or three overlapped windowed 12-point
    IMDCTs (short)."""
    lng, shrt = coefs[:324].reshape(18, 18), coefs[324:396].reshape(6, 12)
    win = coefs[396:].reshape(4, 36)
    z = np.zeros(36, np.float32)
    if b != 2:
        acc = v @ lng
        y = np.concatenate([acc[:9], -acc[8::-1], acc[9:], acc[:8:-1]])
        return y * win[b]
    o = [v[6 * w:6 * w + 6] @ shrt for w in range(3)]
    z[6:12], z[24:30] = o[0][:6], o[2][6:]
    z[12:18], z[18:24] = o[0][6:] + o[1][:6], o[1][6:] + o[2][:6]
    return z


@pytest.mark.parametrize("bt", range(4))
def test_imdct_coefs_reproduce_plain_c5(bt):
    """The coefficients the kernel takes (tables.imdct_coefs) and its
    unfolding give the plain C5's z for every block type."""
    t = build_tables(44100, "cpu")
    rng = np.random.default_rng(bt)
    v = rng.standard_normal((32, 18)).astype(np.float32)
    coefs = t.imdct_coefs_host.numpy()
    got = np.stack([kernel_c5(row, coefs, bt) for row in v])
    if bt == 2:
        want = v @ t.imdct_short.numpy()
    else:
        want = (v @ t.imdct_long.numpy()) * t.windows[bt].numpy()
    assert_close(got, want)


def test_traffic_and_bound_at_decode_batch_shape():
    """Bytes per pair as the bound counts them: 5,188 in (int32 spectrum
    and exponents, int8 block types as the plane decode gives them; 5,194
    with int32 block types, 2,628 with int16 symbols, 4,932 with int16
    exponents) and 9,216 of z or 4,608 of nat out."""
    args = [torch.from_numpy(a) for a in symbols(64, 32, seed=1)]
    wide = [args[0].int(), args[1].int()] + args[2:]
    pairs = 64 * 32
    assert selfcheck.traffic("fused_z", wide)[0] == pairs * (5188 + 9216)
    assert selfcheck.traffic("fused_frontend", wide)[0] == pairs * (5188 + 4608)
    wide_bt = wide[:2] + [args[2].int()] + args[3:]
    assert selfcheck.traffic("fused_z", wide_bt)[0] == pairs * (5194 + 9216)
    assert selfcheck.traffic("fused_z", args)[0] == pairs * (2628 + 9216)
    widened = [args[0].int()] + args[1:]   # int16 exponents, widened planes
    assert selfcheck.traffic("fused_z", widened)[0] == pairs * (4932 + 9216)
    b = selfcheck.bound("fused_z", wide)
    assert b["bound_by"] == "bytes"
    assert b["bound_us"] == pytest.approx(pairs * 14404 / 3.35e12 * 1e6)


@functools.cache
def tonal_clip():
    path = Path(__file__).parent / "torch_clips" / "tonal.mp3"
    return load_symbols(path.read_bytes())[0]


def wrong_kernel(case: str, plain, args, tables):
    """What a kernel would return with the fault `case`, and whether the
    old tolerance (1e-5 of the call's largest |out|) let it pass."""
    want = plain(*args, tables)
    if case == "rounding":          # 4 ulp everywhere: no fault
        got = want * (1 + 4 * 2.0 ** -24)
    elif case == "real_window_zeroed":
        got = want.clone()
        got[0] = 0
    elif case == "low_exponents_off":
        exp = args[1]
        got = plain(args[0], torch.where(exp < -60, exp + 1, exp), *args[2:],
                    tables)
    else:                           # one subband of one pair off by 1e-4
        got = want.clone()
        got.view(*want.shape[:3], 32, -1)[1, 5, :, 7] *= 1 + 1e-4
    old_ok = bool((got - want).abs().max() <= 1e-5 * want.abs().max())
    return got, want, old_ok


@pytest.mark.parametrize("name", sorted(selfcheck.KERNELS))
@pytest.mark.parametrize("case", ("rounding", "real_window_zeroed",
                                  "low_exponents_off", "one_subband_off"))
def test_compare_fails_a_wrong_kernel(name, case):
    """selfcheck.compare, which holds each kernel to its plain version on
    the card, passes float32 rounding and fails a kernel that zeroes a real
    window, misses low-exponent bands or one subband: faults that 1e-5 of
    the call's largest value let through."""
    t = build_tables(44100, "cpu")
    args = selfcheck.random_symbols(2, 32, seed=2, real=[tonal_clip()],
                                    device="cpu")
    got, want, old_ok = wrong_kernel(case, selfcheck.KERNELS[name][1], args, t)
    if case == "rounding":
        selfcheck.compare(name, got, want, case)
        return
    if case != "one_subband_off":
        assert old_ok  # what the per-call tolerance could not see
    with pytest.raises(AssertionError, match="subbands beyond REL_TOL"):
        selfcheck.compare(name, got, want, case)


@pytest.mark.cuda
@pytest.mark.parametrize("check", sorted(selfcheck.CHECKS))
def test_kernel_checks_on_card(check):
    """Odd pair counts, every input type, bit-identity across launches and
    batch sizes, zero pairs (kernels/selfcheck.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    selfcheck.CHECKS[check]("fused_z", build_tables(44100, "cuda"))
    torch.cuda.synchronize()
