"""The port's StreamScheduler into tiny ring buffers with concurrent consumer
threads (the counterpart of test_stress.py, on a committed clip where that
test needs LAME): no deadlock, every stream arrives bit-identical to the
same scheduler configuration routed to CollectSink, and underruns occur only
when the consumer outpaces production."""
import os
import threading
import time

import numpy as np
import pytest
import torch

from mp3tpu_torch.player import CollectSink, RingBuffer, StreamScheduler
from mp3tpu_torch.soak import _RingSink as RingSink

torch.set_num_threads(1)

N_STREAMS = 6


@pytest.fixture(scope="module")
def mp3():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_clips", "sweep.mp3")
    with open(path, "rb") as f:
        return f.read()


def scheduler():
    return StreamScheduler(n_slots=3, win=16, sample_rate=44100, device="cpu")


@pytest.fixture(scope="module")
def ref(mp3):
    sched = scheduler()
    sink = CollectSink()
    sched.submit(mp3, sink=sink, stream_id=0, apply_gapless=False)
    sched.run()
    return sink.pcm


def paced(ring, out, done):
    """Pops only what the ring holds: never outpaces production."""
    while True:
        avail = ring.fill
        if avail:
            out.append(ring.pop(min(512, avail)))
        elif done.is_set():
            return
        else:
            time.sleep(0.0005)


def blind(ring, out, done):
    """Pops 512 samples every half millisecond whatever the ring holds, as a
    realtime callback at about 20x realtime would: zero-padded on an
    underrun. Chunks of zeros only are dropped as they come (the comparison
    drops zero rows anyway)."""
    while True:
        chunk = ring.pop(512)
        if chunk.any():
            out.append(chunk)
        if done.is_set() and ring.fill == 0:
            return
        time.sleep(0.0005)


@pytest.mark.parametrize("consumer", [paced, blind], ids=["paced", "blind"])
def test_scheduler_into_tiny_rings_with_consumers(mp3, ref, consumer):
    rings = [RingBuffer(4096, 2) for _ in range(N_STREAMS)]
    outs = [[] for _ in range(N_STREAMS)]
    done = threading.Event()
    threads = [threading.Thread(target=consumer, args=(rings[i], outs[i], done),
                                daemon=True) for i in range(N_STREAMS)]
    for t in threads:
        t.start()
    sched = scheduler()
    try:
        for i in range(N_STREAMS):
            sched.submit(mp3, sink=RingSink(rings[i]), stream_id=i,
                         apply_gapless=False)
        sched.run()
    finally:
        done.set()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive(), "consumer deadlocked"
    assert sched.metrics.streams_finished == N_STREAMS
    assert sched.steps == sum(e == "dispatch" for e, _ in sched.trace) > 0
    assert ref.shape == (768 * 576, 2)  # every granule, no gapless trim

    underruns = sum(r.underruns for r in rings)
    if consumer is paced:
        for out in outs:
            assert np.array_equal(np.concatenate(out), ref)
        assert underruns == 0 and sched.metrics.underruns == 0
        return
    # a blind consumer pops an empty ring before its stream's first push and
    # after its last: those pops come back zero-padded and count as
    # underruns, which the scheduler books from the sinks as it pushes
    assert 0 < sched.metrics.underruns <= underruns
    refnz = ref[(ref != 0).any(axis=1)]
    for out in outs:
        got = np.concatenate(out)
        flat = got[(got != 0).any(axis=1)]
        assert np.array_equal(flat, refnz)
