"""transcode_batch of the configuration's corpus clips, one a stream, to
the mix's bitrate: MP3 in, MP3 out, the PCM on the device between the
decode and the encode.

Both halves are checked. The decode half's output is the DecodedBatch that
transcode_batch hands to the encoder: a wrapper around
mp3tpu_torch.pipeline.decode_files (where transcode_batch looks it up)
keeps the call's handle, and a sampled stream's int16 PCM is copied from
it, its own row only, when the sample takes it. The encode half's output
is the MP3 bytes."""
from __future__ import annotations

from dataclasses import dataclass

from .. import compose, reference
from ..checks import decode_numbers, encoded_numbers
from .encode_batch import lower_bitrate

_HANDLE: dict = {}


@dataclass
class Batch:
    inputs: list        # MP3 bytes, one a stream
    plan: list          # clip indices of each stream
    bitrate: int
    seconds: list       # the source audio of each stream


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
                            len(clips), compose.rng(seed, 3, b))
        batches.append(Batch(
            inputs=[compose.compose([clips[i] for i in p]) for p in plan],
            plan=plan, bitrate=t["bitrate_kbps"],
            seconds=[sum(clips[i].samples / clips[i].sample_rate for i in p)
                     for p in plan]))
    return Work(batches=batches, clips=clips)


@dataclass
class Result:
    mp3s: list          # the encode half's output
    handle: object      # the decode half's: the DecodedBatch, or None


def _keep_handles() -> None:
    from mp3tpu_torch import pipeline
    if getattr(pipeline.decode_files, "_keeps_handle", False):
        return
    orig = pipeline.decode_files

    def decode_files(*a, **kw):
        _HANDLE["last"] = out = orig(*a, **kw)
        return out
    decode_files._keeps_handle = True
    pipeline.decode_files = decode_files


def call(m, batch: Batch, device):
    _keep_handles()
    _HANDLE.clear()
    mp3s = m.transcode_batch(batch.inputs, bitrate=batch.bitrate,
                             device=device)
    return Result(mp3s, _HANDLE.pop("last", None))


def completed(res: Result, batch: Batch) -> tuple:
    # a stream's audio: its parts' source PCM, which the gapless decode
    # gives back whole
    audio, failed = 0.0, len(batch.inputs) - len(res.mp3s)
    for s, out in zip(batch.seconds, res.mp3s):
        if out:
            audio += s
        else:
            failed += 1
    return audio, failed


def keep(res: Result, batch: Batch, k: int):
    """(MP3 bytes, (decoded int16 PCM, rate) or None) of stream k."""
    mp3 = res.mp3s[k] if k < len(res.mp3s) else None
    pcm = None
    if res.handle is not None and k < len(res.handle):
        chunk, row, lo, hi, nch = res.handle.device_pcm(k)
        part = chunk[row, lo:hi, :nch]
        pcm = (part.cpu().numpy() if hasattr(part, "cpu") else part.copy(),
               res.handle.sample_rates[k])
    return mp3, pcm


def check(kept, work: Work, cell) -> dict:
    """Both halves: the input decoded by the reference is what the output
    must hold."""
    want, pairs, items = {}, [], []
    for b, k, (mp3, pcm) in kept:
        key = tuple(work.batches[b].plan[k])
        if key not in want:
            want[key] = reference.decode(work.batches[b].inputs[k])
        ref_pcm, rate = want[key]
        pairs.append((pcm, ref_pcm, rate))
        items.append((mp3, ref_pcm / 32768.0))
    numbers = decode_numbers(pairs)
    enc = encoded_numbers(items, cell.config["format"],
                          cell.traffic["bitrate_kbps"])
    numbers["streams_off"] += enc.pop("streams_off")
    numbers.update(enc)
    return numbers


def control(kept, work: Work, cell, m, device) -> list:
    """Each half's control in the program's place: for the decode half,
    the reference at TF32, one precision below the program's float32
    (decode_files.control); for the encode half, the program at the next
    lower bitrate."""
    lower = lower_bitrate(cell.traffic["bitrate_kbps"])
    out = []
    for b, k, _kept in kept:
        data = work.batches[b].inputs[k]
        mp3, _pcm = keep(call(m, Batch([data], [], lower, []), device),
                         None, 0)
        out.append((b, k, (mp3, reference.decode(data, "tf32", device))))
    return out
