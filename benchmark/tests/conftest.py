"""The benchmark's own tests: on the CPU at cut sizes, and (marked cuda) on
the card. Run from the root of a checkout:

    python -m pytest benchmark/tests -q            # the CPU tests
    python -m pytest benchmark/tests -q -m cuda    # on a card
"""
import os
import sys

import numpy as np
import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (os.path.join(ROOT, "src"), BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; decides inside the test")


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def cut_clips(clips, n_frames: int):
    """The clips cut to their first n_frames audio frames (a test size)."""
    from mp3bench.reference.container import frames as fr
    out = []
    for c in clips:
        idx = fr.scan_frames(np.frombuffer(c.audio, np.uint8))
        n = min(n_frames, idx.n_frames)
        end = int(idx.offsets[n]) if n < idx.n_frames else len(c.audio)
        c.audio, c.n_audio_frames = c.audio[:end], n
        c.samples = n * 1152 - c.delay - c.padding
        out.append(c)
    return out


@pytest.fixture
def small(monkeypatch):
    """small(workload) -> the cell cut to a test size: 8 streams a call of
    clips cut to 40 frames (3 windows of 32 granules), or of 0.5 s of PCM,
    two distinct batches, short warm-up."""
    from mp3bench import compose, spec
    orig = compose.load_corpus
    monkeypatch.setattr(compose, "load_corpus",
                        lambda config, root: cut_clips(orig(config, root), 40))

    def make(workload, root=ROOT):
        cell = spec.load_cell(workload, root)
        cell.traffic.update(streams_per_call=8, distinct_batches=2,
                            trace_calls=1, check_streams=4)
        if "stream_seconds" in cell.traffic:
            cell.traffic["stream_seconds"] = 0.5
        cell.traffic["warmup"] = {"min_calls": 1, "max_calls": 1,
                                  "agree_pct": 3}
        return cell
    return make
