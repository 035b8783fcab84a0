"""mp3tpu_torch.decode_batch on the CPU, held against mp3tpu.decode_batch
(JAX CPU backend) on the same files, and the config-3 resampled program
against the JAX one."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mp3tpu
import mp3tpu_torch
from mp3tpu.kernels import pipeline as kp
from mp3tpu_torch.bitstream import native
from mp3tpu_torch.kernels import pipeline as tp
from mp3tpu_torch.pipeline import probe_granules, stream_meta, unpack_planes
from test_torch_decode import assert_i16_close, clip

requires_native = pytest.mark.skipif(not native.available(),
                                     reason="native unpacker unavailable")


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@requires_native
@pytest.mark.parametrize("kinds", [("sweep", "transients", "tonal", "lsf22050",
                                    "lsf8000"),
                                   ("lame_sweep", "lame_transients", "tonal")])
def test_decode_batch_matches_jax(kinds):
    datas = [clip(k) for k in kinds]
    want = mp3tpu.decode_batch(datas)
    got = mp3tpu_torch.decode_batch(datas, device="cpu")
    assert len(got) == len(want)
    for (g, sg), (w, sw) in zip(got, want):
        assert sg == sw
        assert_i16_close(g, w)
    # the batch path agrees with the single-file path of the port
    single, _ = mp3tpu_torch.decode(datas[0], device="cpu")
    assert_i16_close(got[0][0], single)


def test_decode_batch_unported_paths_raise():
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        mp3tpu_torch.decode_batch([clip("tonal")], device="cpu", output="device")


@requires_native
def test_config3_resampled_program_matches_jax():
    """decode_all_windows_flat_resampled_i16 at S=2 (4-bit planes, 48 kHz)."""
    bodies = [stream_meta(clip(k))[0] for k in ("tonal", "transients")]
    Gs = [probe_granules(b) for b in bodies]
    planes, _errs, bits, exp_bytes = unpack_planes(bodies, Gs, 2, 32, 4)
    assert (bits, exp_bytes) == (4, True)
    keys = ("is12", "exp", "esc", "bt", "mx", "smode")
    got, st, rst = tp.decode_all_windows_flat_resampled_i16(
        *(t(planes[k]) for k in keys), tp.init_state(2, device="cpu"),
        tp.init_resample_state(2, 44100, device="cpu"), 44100, 48000, 4)
    want, sj, rsj = kp.decode_all_windows_flat_resampled_i16(
        *(jnp.asarray(planes[k]) for k in keys), kp.init_state(2),
        kp.init_resample_state(2, 44100), 44100, 48000, 4)
    assert_i16_close(got.numpy(), np.asarray(want))
    rel = np.abs(rst.numpy() - np.asarray(rsj)).max() / np.abs(np.asarray(rsj)).max()
    assert rel <= 1e-5
    assert np.abs(st["hist"].numpy() - np.asarray(sj["hist"])).max() <= \
        1e-5 * np.abs(np.asarray(sj["hist"])).max()
