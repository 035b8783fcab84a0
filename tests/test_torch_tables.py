"""The PyTorch port's constant tables and state converters, held against
the JAX package's build_tables and init_state."""
import numpy as np
import pytest
import torch

from mp3tpu.kernels import pipeline as kp
from mp3tpu_torch.dsp.resample import Resampler
from mp3tpu_torch.kernels import tables as tt

RATES = (8000, 11025, 12000, 16000, 22050, 24000, 32000, 44100, 48000)
JAX_FIELDS = ("band_oh", "ra", "imdct_long", "imdct_short", "windows",
              "palette4", "synth_fir", "inv_mask")


@pytest.mark.parametrize("sr", RATES)
def test_tables_equal_jax(sr):
    """Exact: both packages round the same float64 sources to float32."""
    ours = tt.build_tables(sr, "cpu")
    ref = kp.build_tables(sr)
    for f in JAX_FIELDS:
        a, b = np.asarray(getattr(ref, f)), getattr(ours, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a, b), f


@pytest.mark.parametrize("sr", (8000, 22050, 44100))
def test_index_forms_compose_to_ra(sr):
    """The band map, reorder map and alias gather are the one-hot and
    composed matrices of the JAX tables, written as indices: rebuilding
    band_oh and ra from them gives the JAX arrays exactly."""
    t = tt.build_tables(sr, "cpu")
    ref = kp.build_tables(sr)
    bm = t.band_map.numpy()
    oh = np.zeros((3, 64, 576), np.float32)
    for f in range(3):
        oh[f, bm[f], np.arange(576)] = 1.0
    assert np.array_equal(oh, np.asarray(ref.band_oh))

    rm = t.reorder_map.numpy()
    part, self_c, cross_c = (t.alias_partner.numpy(), t.alias_self.numpy(),
                             t.alias_cross.numpy())
    ra = np.zeros((3, 576, 576), np.float32)
    for f in range(3):
        j = np.arange(576)
        ra[f, rm[f], j] += self_c[f]
        nz = cross_c[f] != 0
        ra[f, rm[f][part[f][nz]], j[nz]] += cross_c[f][nz]
    assert np.array_equal(ra, np.asarray(ref.ra))
    assert t.n_alias.tolist() == [31, 0, 1]
    # the kernel's IMDCT coefficients are the plain tables' own values
    coefs = t.imdct_coefs_host.numpy()
    assert np.array_equal(coefs[:324].reshape(18, 18),
                          t.imdct_long.numpy()[:, np.r_[0:9, 18:27]])
    assert np.array_equal(coefs[324:396].reshape(6, 12),
                          t.imdct_short.numpy()[:6, 6:18])
    assert np.array_equal(coefs[396:].reshape(4, 36), t.windows.numpy())


def test_tables_round_trip():
    t = tt.build_tables(44100, "cpu")
    d = tt.tables_to_numpy(t)
    assert set(d) == {name for name, _ in tt.FIELDS}
    back = tt.tables_from_numpy(d, "cpu")
    for name, buf in t.named_buffers():
        assert torch.equal(buf, getattr(back, name)), name


def test_tables_from_jax_arrays():
    """The JAX package's arrays, completed with the index forms, build
    the same module as the port's own tables."""
    ref = kp.build_tables(32000)
    d = tt.tables_to_numpy(tt.build_tables(32000, "cpu"))
    d.update({f: np.asarray(getattr(ref, f)) for f in JAX_FIELDS})
    t = tt.tables_from_numpy(d, "cpu")
    own = tt.build_tables(32000, "cpu")
    for name, buf in own.named_buffers():
        assert torch.equal(buf, getattr(t, name)), name


def test_state_round_trip():
    rng = np.random.default_rng(5)
    st = {k: np.asarray(v) + rng.standard_normal(np.shape(v)).astype(np.float32)
          for k, v in kp.init_state(3).items()}
    got = tt.state_to_numpy(tt.state_from_numpy(st, "cpu"))
    assert set(got) == {"overlap", "hist"}
    for k in st:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], st[k])
    hist = np.asarray(kp.init_resample_state(2, 44100)) + 0.25
    back = tt.state_to_numpy(tt.state_from_numpy(hist, "cpu"))
    assert back.shape == (2, 24, 2) and np.array_equal(back, hist)
    rs = Resampler(44100, 48000, device="cpu")
    carry = (rng.standard_normal((rs.state_len, 2)).astype(np.float32), 1000, 1088)
    back = tt.state_to_numpy(tt.state_from_numpy(carry, "cpu"))
    assert np.array_equal(back[0], carry[0]) and back[1:] == (1000, 1088)
