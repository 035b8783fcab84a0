"""mp3tpu_torch.decode on the CPU, held against mp3tpu.decode (JAX CPU
backend) on the same files; the batch path is in test_torch_decode_batch.py."""
import numpy as np
import pytest
import torch

import fixtures
import mp3tpu
import mp3tpu_torch

# The suite runs in several pytest-xdist workers, each of which imports
# this module: one torch thread per worker, or the workers' intra-op thread
# pools oversubscribe the cores (measured: the port's tests ran 4.5x longer
# on 8 cores with 6 workers).
torch.set_num_threads(1)


def crafted(kind: str) -> bytes:
    """Hand-crafted probe streams (tools/craft.py): the mixed-block and
    intensity-stereo paths no encoder fixture reaches."""
    from craft import (GranuleSpec, craft_stream, craft_stream_lsf_stereo,
                       craft_stream_stereo)
    pairs = ("000" + "00") * 30
    ch0 = GranuleSpec(part2_3_length=len(pairs), big_values=30,
                      table_select=(1, 1, 1), region0_count=6,
                      region1_count=7, main_bits=pairs)
    if kind == "mixed":
        return craft_stream(GranuleSpec(
            part2_3_length=len(pairs), big_values=30, window_switching=1,
            block_type=2, mixed_block_flag=1, table_select=(1, 1, 0),
            main_bits=pairs))
    if kind == "intensity":   # MPEG-1 MS + intensity, 3-bit positions
        bits = "".join(format(p, "03b") for p in [1, 2, 0, 3, 6, 5, 4] + [2] * 4)
        ch1 = GranuleSpec(part2_3_length=len(bits), big_values=0,
                          scalefac_compress=4, main_bits=bits)
        return craft_stream_stereo((ch0, ch1), mode=1, mode_ext=0b11)
    # LSF intensity (22.05 kHz): slen (3,3,3), scale 1
    bits = "".join(format(p, "03b") for p in [1, 2, 3, 4, 0, 5, 6] + [1] * 14)
    ch1 = GranuleSpec(part2_3_length=len(bits), big_values=0,
                      scalefac_compress=(129 << 1) | 1, main_bits=bits)
    return craft_stream_lsf_stereo((ch0, ch1), mode=1, mode_ext=0b01)


def clip(kind: str) -> bytes:
    if kind.startswith("craft_"):
        return crafted(kind[6:])
    if kind.startswith("lsf"):
        return fixtures.lsf_fixture(int(kind[3:]))
    if kind.startswith("lame_"):
        pytest.importorskip("lameref")
        return fixtures.lame_fixture(kind[5:], ch=2, bitrate=128, mode="jstereo")
    return fixtures.own_fixture(kind)


def assert_i16_close(got, want):
    """float32 pipelines that sum in another order: the int16 contract of
    every mp3tpu path, at most 1 LSB and at least 98% exact."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.int16
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d == 0).mean() >= 0.98


@pytest.mark.parametrize("kind", ["sweep", "transients", "tonal", "lsf8000",
                                  "lsf11025", "lsf12000", "lsf16000",
                                  "lsf22050", "lsf24000", "lame_sweep",
                                  "lame_transients", "craft_mixed",
                                  "craft_intensity", "craft_lsf_intensity"])
def test_decode_matches_jax(kind):
    data = clip(kind)
    want, sr_want = mp3tpu.decode(data)
    got, sr_got = mp3tpu_torch.decode(data, device="cpu")
    assert sr_got == sr_want
    assert_i16_close(got, want)


@pytest.mark.parametrize("kind", ["transients", "craft_mixed", "craft_intensity",
                                  "craft_lsf_intensity"])
def test_decode_float32_matches_jax(kind):
    """float32 PCM, where int16 rounding would hide small differences."""
    data = clip(kind)
    want, _ = mp3tpu.decode(data, output="float32")
    got, _ = mp3tpu_torch.decode(data, device="cpu", output="float32")
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
