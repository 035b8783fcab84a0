"""One run of one cell: set-up, warm-up, the measured window, the traced
calls (--trace 1), the check against the plain reference, and the result.

Protocol, for every cell:

- set-up: the cell's inputs are made from the seed and held in memory
  (a few distinct batches, cycled); the program is imported; the cell's own
  call runs until two calls in a row agree within the mix's
  warmup.agree_pct, or warmup.max_calls is reached. That pays the builds,
  the CUDA context, the thread pools and the allocator. setup_s is the
  process's time until then.
- the window: one closed-loop client calls the entry back to back for
  --seconds; the rate is the audio of every call completed, over the time
  from the window's start to the last completion. Between calls the
  harness only keeps a seeded sample of the outputs (reservoir sampling
  of the streams) for the check and drops the rest.
- --trace 1: the same window with the per-layer metrics' timers and
  counters installed, then the mix's trace_calls calls under
  torch.profiler.
- after the window: the peak of device memory is read, the program's
  outputs are freed, and the kept sample is held to the reference.

Standard output: a line of facts (host CPU, card, clocks and power limit
before and after the window), a line with every call's time, then the
result as one JSON object on the last line. Standard error ends with one
line per number compared, beside its limit.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import random
import subprocess
import sys
import time
from types import SimpleNamespace

from . import spec
from .checks import verdict
from .probe import Probe

FORBIDDEN = ("jax", "jaxlib", "flax", "mp3tpu")


def forbidden_modules() -> list:
    """Top-level names in sys.modules that the benchmark must not load,
    compared whole (mp3tpu_torch is not mp3tpu)."""
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def host_facts() -> dict:
    model = ""
    with contextlib.suppress(OSError):
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    return {"cpu": model, "cpus": os.cpu_count(),
            "cpus_usable": len(os.sched_getaffinity(0))}


def card_facts() -> str:
    """nvidia-smi's name, power limit and draw, SM clock and its maximum,
    temperature, or the reason there are none."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 else r.stderr.strip()
    except (OSError, subprocess.TimeoutExpired, IndexError) as e:
        return f"nvidia-smi: {e}"


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _counters(m) -> int:
    g = m.global_metrics()
    return g.frames_error + g.resyncs + g.granules_muted


class Sampler:
    """A seeded reservoir sample of n streams over every call offered: the
    outputs the check holds to the reference. The rest is dropped at once."""

    def __init__(self, n: int, seed):
        self.n, self.seen, self.kept = n, 0, []
        self._pick = random.Random(f"keep {seed}")

    def offer(self, entry, b: int, batch, outs) -> None:
        for k in range(len(batch.inputs)):
            self.seen += 1
            j = (len(self.kept) if len(self.kept) < self.n
                 else self._pick.randrange(self.seen))
            if j < self.n:
                self.kept[j:j + 1] = [(b, k, entry.keep(outs, batch, k))]


class Calls:
    """The cell's own call on its cycled batches, timed with the card's
    queue drained at both ends; the program's prints go to stderr."""

    def __init__(self, cell, work, device):
        import mp3tpu_torch
        self.m = mp3tpu_torch
        self.entry = spec.load_entry(cell.entry)
        self.work, self.device, self.i = work, device, 0

    def __call__(self):
        b = self.i % len(self.work.batches)
        batch = self.work.batches[b]
        self.i += 1
        _sync(self.device)
        c0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            outs = self.entry.call(self.m, batch, self.device)
        _sync(self.device)
        wall = time.perf_counter() - c0
        audio, failed = self.entry.completed(outs, batch)
        return b, batch, outs, wall, audio, failed

    def warm(self, w: dict) -> list:
        """Calls until two in a row agree within w["agree_pct"] (at least
        w["min_calls"], at most w["max_calls"]); their walls."""
        walls = []
        while True:
            walls.append(self()[3])
            if len(walls) >= w["max_calls"] or (
                    len(walls) >= w["min_calls"]
                    and abs(walls[-1] / walls[-2] - 1) * 100 <= w["agree_pct"]):
                return walls

    def window(self, sampler, seconds: float | None = None,
               n_calls: int | None = None, probe=None) -> dict:
        """Back-to-back calls for `seconds` (or n_calls calls); the rate is
        the audio completed over the time to the last completion."""
        out = {"walls": [], "attempted": 0, "failed": 0, "audio": 0.0}
        w0 = time.perf_counter()
        while (time.perf_counter() - w0 < seconds if n_calls is None
               else len(out["walls"]) < n_calls):
            b, batch, outs, wall, audio, failed = self()
            w_end = time.perf_counter()
            if probe is not None:
                probe.after_call()
            out["walls"].append(wall)
            out["attempted"] += len(batch.inputs)
            out["failed"] += failed
            out["audio"] += audio
            sampler.offer(self.entry, b, batch, outs)
            del outs
        out["rate"] = out["audio"] / (w_end - w0)
        return out

    def check(self, sampler, cell, failed: int, faults: int) -> dict:
        numbers = self.entry.check(sampler.kept, self.work, cell)
        numbers["streams_failed"] = failed
        numbers["decode_faults"] = faults
        return numbers


def measure(cell, seed: int, seconds: float, trace: bool, t0: float,
            device="cuda", log=print) -> dict:
    """The result of one run (the last line's object, "checks" last)."""
    import torch
    t = cell.traffic
    work = spec.load_entry(cell.entry).prepare(cell, seed)
    calls = Calls(cell, work, device)
    m = calls.m
    probe = Probe()
    readers = {}
    if trace:
        for metric in cell.per_layer:
            readers[metric["name"]] = spec.load_metric(metric["name"], cell.root)
            if hasattr(readers[metric["name"]], "instrument"):
                readers[metric["name"]].instrument(probe)
    warm = calls.warm(t["warmup"])
    gc.collect()
    setup_s = time.perf_counter() - t0
    card_before = card_facts() if device != "cpu" else None

    sampler = Sampler(t["check_streams"], seed)
    faults0 = _counters(m)
    probe.open_window()
    win = calls.window(sampler, seconds=seconds, probe=probe)
    probe.close_window()
    decode_faults = _counters(m) - faults0
    card_after = card_facts() if device != "cpu" else None

    traced = None
    if trace:
        def traced_calls():
            for _ in range(t["trace_calls"]):
                with torch.profiler.record_function("bench.call"):
                    calls()
        from .trace import capture
        traced = capture(traced_calls)
    peak = (torch.cuda.max_memory_allocated() if device != "cpu" else 0)
    probe.restore()
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()

    log(json.dumps({"log": "facts", "workload": cell.name, "seed": seed,
                    "host": host_facts(), "card_before": card_before,
                    "card_after": card_after, "torch": torch.__version__,
                    "cuda": torch.version.cuda}))
    log(json.dumps({"log": "calls", "warmup_s": warm, "window_s": win["walls"],
                    "rate": win["rate"], "setup_s": setup_s}))

    numbers = calls.check(sampler, cell, win["failed"], decode_faults)
    correct, table = verdict(numbers, cell.limits)

    if trace:
        ctx = SimpleNamespace(cell=cell, probe=probe, trace=traced,
                              calls=win["walls"], program=m.config.get_active())
        metrics = {}
        for metric in cell.per_layer:
            v = readers[metric["name"]].read(ctx)
            if v is not None:
                metrics[metric["name"]] = {"value": v, "unit": metric["unit"]}
    else:
        metrics = {}
        for metric in cell.end_to_end:
            v = setup_s if metric["name"] == "setup_s" else win["rate"]
            metrics[metric["name"]] = {"value": v, "unit": metric["unit"]}
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device != "cpu"
                    else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": win["attempted"],
              "failed": win["failed"], "metrics": metrics, "device": dev}
    if traced is not None:
        dev["busy_s"] = traced["busy_s"]
        dev["window_s"] = traced["window_s"]
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    result["checks"] = table
    return result


def parse(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True, help="<config>.<traffic>")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0: float) -> int:
    a = parse(argv)
    cell = spec.load_cell(a.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{a.workload} needs {cell.chips} CUDA device(s); this host "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}:"
              " the benchmark measures the card and does not fall back to "
              "the CPU", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = measure(cell, a.seed, a.seconds, bool(a.trace), t0)
    bad = forbidden_modules()
    if bad:
        print(f"modules the benchmark must not load are loaded: {bad}",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {name} {c['value']} limit {c['limit']} {ok}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
