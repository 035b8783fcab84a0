"""mp3tpu_torch.utils.profiling on the CPU: device_trace writes a
torch.profiler trace that holds the decode's annotations, and is a no-op
with no directory; annotate leaves results alone. The spans:
test_torch_spans.py."""
import glob
import json
import os

import numpy as np
import pytest
import torch

import fixtures
import mp3tpu_torch
from mp3tpu_torch.utils import profiling
from test_torch_decode import clip  # noqa: F401  (one torch thread)


@pytest.fixture(scope="module")
def mp3():
    return fixtures.own_fixture("tonal")


def span_names(logdir):
    [path] = glob.glob(os.path.join(str(logdir), "*.trace.json"))
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_device_trace_is_a_noop_without_a_directory(monkeypatch, tmp_path):
    monkeypatch.delenv("MP3TPU_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with profiling.device_trace():
        with profiling.annotate("mp3tpu.test_span"):
            x = torch.ones(4).sum()
    assert float(x) == 4.0 and os.listdir(tmp_path) == []


def test_device_trace_writes_the_annotations(tmp_path):
    with profiling.device_trace(str(tmp_path / "t")):
        with profiling.annotate("mp3tpu.test_span"):
            torch.ones(4).sum()
    names = span_names(tmp_path / "t")
    assert "mp3tpu.test_span" in names and "aten::sum" in names


def test_decode_runs_under_the_trace(mp3, monkeypatch, tmp_path):
    """decode() with MP3TPU_TRACE_DIR set leaves a trace with one span per
    group of windows, and the PCM of a run without it."""
    monkeypatch.delenv("MP3TPU_TRACE_DIR", raising=False)
    want, _ = mp3tpu_torch.decode(mp3, device="cpu")
    monkeypatch.setenv("MP3TPU_TRACE_DIR", str(tmp_path))
    got, _ = mp3tpu_torch.decode(mp3, device="cpu")
    assert np.array_equal(got, want)
    groups = [n for n in span_names(tmp_path)
              if n and n.startswith("mp3tpu.decode_group[")]
    assert groups == ["mp3tpu.decode_group[0:80]"]


def test_batch_and_chunked_paths_are_annotated(mp3, tmp_path):
    from mp3tpu_torch import pipeline as tpl
    from mp3tpu_torch.bitstream import native
    st, _info, _ = tpl.load_symbols(mp3)
    with profiling.device_trace(str(tmp_path)):
        tpl.decode_symbols_chunked(st, chunk_granules=16, device="cpu")
        if native.available():
            mp3tpu_torch.levels_batch([mp3], device="cpu")
    names = span_names(tmp_path)
    assert any(n.startswith("mp3tpu.decode_chunked[") for n in names if n)
    if native.available():
        assert "mp3tpu.env_batch" in names
        assert any(n.startswith("mp3tpu.decode_chunk[") for n in names if n)


def test_annotate_passes_exceptions_through():
    with pytest.raises(KeyError):
        with profiling.annotate("mp3tpu.fails"):
            raise KeyError("x")
