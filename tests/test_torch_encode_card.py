"""encode_batch's int16 staging on the card (marked cuda; skips without
one): the pinned staging buffer that calls reuse, the wait for its last copy,
and the bytes of int16-origin batches against the float32 route with host
labels. Run on a card with

    MP3TPU_TEST_PLATFORM=cuda python3 -m pytest tests/test_torch_encode_card.py -m cuda
"""
import numpy as np
import pytest
import torch

import fixtures
import mp3tpu_torch
from mp3tpu_torch.encoder import device as tdev

SR = 44100


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def i16_origin(sig):
    return np.round(np.clip(sig, -1, 1) * 32767) / 32768.0


def streams(nch, seconds=2.0):
    """Int16-origin clicks and bursts, and a tone, at unequal lengths."""
    n = int(seconds * SR)
    t = np.arange(n) / SR
    tone = 0.4 * np.sin(2 * np.pi * 440 * t)[:, None].repeat(nch, 1)
    out = [i16_origin(fixtures.transients(seconds, SR, nch)),
           i16_origin(tone[: n * 2 // 3])]
    return [p[:, 0] for p in out] if nch == 1 else out


def encode(pcms, **kw):
    return mp3tpu_torch.encode_batch(pcms, SR, bitrate=128, device="cuda", **kw)


def fresh(monkeypatch, pcms):
    """encode_batch on a staging buffer no call has used."""
    with monkeypatch.context() as m:
        m.setattr(tdev, "_STAGE", {"buf": None, "copied": None})
        return encode(pcms)


@pytest.mark.cuda
@pytest.mark.parametrize("nch", [1, 2])
def test_int16_staging_equals_the_f32_route_on_card(nch, monkeypatch):
    """Labels from the card's float64 energies and the int16 staging give
    the bytes of float32 staging with float64 host labels; the buffer is
    pinned."""
    need_card()
    pcms = streams(nch)
    got = encode(pcms)
    assert tdev._STAGE["buf"].is_pinned()
    with monkeypatch.context() as m:
        m.setattr(tdev, "FORCE_F32_STAGE", True)
        assert encode(pcms) == got


@pytest.mark.cuda
def test_reused_buffer_on_card_gives_fresh_bytes(monkeypatch):
    """Smaller, larger, smaller again, and two calls on side streams in
    turn, as encode_batch(mesh=) runs its shards: each call's bytes are a
    fresh call's."""
    need_card()
    two = streams(2)
    calls = [[two[1][:30000]], two, [two[0][:50000], two[1][:7000]]]
    want = [fresh(monkeypatch, c) for c in calls]
    monkeypatch.setattr(tdev, "_STAGE", {"buf": None, "copied": None})
    assert [encode(c) for c in calls] == want
    got = []
    for c in calls[1:]:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            got.append(encode(c))
        torch.cuda.current_stream().wait_stream(side)
    assert got == want[1:]


@pytest.mark.cuda
def test_stage_int16_waits_for_its_last_copy():
    """Back-to-back stagings of 64 x 10 s: the first copy still lands with
    the first batch's samples though the second call rewrites the buffer."""
    need_card()
    rng = np.random.default_rng(5)
    ks = [rng.integers(-32768, 32768, (64, 441000, 2)).astype(np.int16)
          for _ in range(2)]
    pcms = [[k / 32768.0 for k in batch] for batch in ks]
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        first = tdev.stage_int16(pcms[0], "cuda")
        second = tdev.stage_int16(pcms[1], "cuda")
    torch.cuda.synchronize()
    assert np.array_equal(first.cpu().numpy(), ks[0])
    assert np.array_equal(second.cpu().numpy(), ks[1])
