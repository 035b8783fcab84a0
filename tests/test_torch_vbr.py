"""VBR quality floors that both packages must pass: mp3tpu.encoder.encode_pcm
and the port's, at vbr_quality 2, 5 and 8 on two signals. Each quality has an
SNR floor set a little under what both packages measure (they give the same
bytes, so the same numbers), and the stream sizes fall as the quality index
rises.
"""
import numpy as np
import pytest

import fixtures
import mp3tpu_torch
from mp3tpu.encoder import encode_pcm as jax_encode_pcm
from mp3tpu_torch.container import frames as fr
from mp3tpu_torch.encoder import encode_pcm as port_encode_pcm

SR = 44100
SECONDS = 0.6
# measured, the same in both packages, at quality 2 / 5 / 8: tonal 51.48 /
# 47.65 / 39.17 dB in 19,523 / 13,673 / 9,806 bytes; sweep 46.11 / 44.62 /
# 38.40 dB in 14,244 / 11,998 / 9,572 bytes. (The loud noise bursts of
# fixtures.transients fill the largest frame at every quality: no order.)
FLOORS = {"tonal": {2: 50.5, 5: 46.5, 8: 38.0},
          "sweep": {2: 45.0, 5: 43.5, 8: 37.0}}
ENCODERS = {"mp3tpu": lambda sig, q: jax_encode_pcm(
                sig, SR, vbr_quality=q, device_loops=False,
                device_transform=False),
            "mp3tpu_torch": lambda sig, q: port_encode_pcm(
                sig, SR, vbr_quality=q, device="cpu")}


def signal(name):
    return {"tonal": fixtures.tonal_stereo,
            "sweep": fixtures.tone_sweep}[name](SECONDS, SR)


def snr_db(mp3, ref):
    dec, sr = mp3tpu_torch.decode(mp3, output="float32", device="cpu")
    assert sr == SR and dec.shape == ref.shape      # the gapless round trip
    err = dec.astype(np.float64) - ref
    return 10 * np.log10((ref ** 2).mean() / (err ** 2).mean())


@pytest.mark.parametrize("package", list(ENCODERS))
@pytest.mark.parametrize("name", list(FLOORS))
def test_vbr_quality_floors_and_size_order(package, name):
    sig = signal(name)
    sizes, snrs = [], []
    for q in (2, 5, 8):
        mp3 = ENCODERS[package](sig, q)
        index = fr.scan_frames(np.frombuffer(mp3, np.uint8))
        assert index.n_frames >= 20
        sizes.append(len(mp3))
        snrs.append(snr_db(mp3, sig))
        assert snrs[-1] >= FLOORS[name][q], (q, snrs[-1])
    assert sizes[0] > sizes[1] > sizes[2]
    assert snrs[0] > snrs[1] > snrs[2]
