"""decode_files (mp3tpu_torch.decode_batch, output="pcm") of streams
composed from the configuration's corpus: int16 host PCM out, trimmed by
each stream's LAME tag."""
from __future__ import annotations

from dataclasses import dataclass

from .. import compose, reference
from ..checks import decode_numbers


@dataclass
class Batch:
    inputs: list        # MP3 bytes, one a stream
    plan: list          # clip indices of each stream


@dataclass
class Work:
    batches: list
    clips: list


def prepare(cell, seed: int) -> Work:
    t = cell.traffic
    clips = compose.load_corpus(cell.config, cell.root)
    batches = []
    for b in range(t["distinct_batches"]):
        plan = compose.plan(t["streams_per_call"], t["parts_per_stream"],
                            len(clips), compose.rng(seed, 1, b))
        batches.append(Batch(inputs=[compose.compose([clips[i] for i in p])
                                     for p in plan], plan=plan))
    return Work(batches=batches, clips=clips)


def call(m, batch: Batch, device):
    return m.decode_batch(batch.inputs, device=device, output="pcm")


def completed(outputs, batch: Batch) -> tuple:
    audio, failed = 0.0, len(batch.inputs) - len(outputs)
    for out in outputs:
        if out is None or len(out[0]) == 0:
            failed += 1
        else:
            audio += len(out[0]) / out[1]
    return audio, failed


def keep(outputs, batch: Batch, k: int):
    return outputs[k] if k < len(outputs) else None


def reference_pcm(work: Work, b: int, k: int, precision="float64",
                  device="cpu"):
    return reference.decode(work.batches[b].inputs[k], precision, device)


def check(kept, work: Work, cell) -> dict:
    pairs = []
    for b, k, got in kept:
        want, rate = reference_pcm(work, b, k)
        pairs.append((got, want, rate))
    return decode_numbers(pairs)


def control(kept, work: Work, cell, m, device) -> list:
    """The reference at TF32, one precision below the program's float32,
    in the program's place."""
    return [(b, k, reference_pcm(work, b, k, "tf32", device))
            for b, k, _got in kept]
