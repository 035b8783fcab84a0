"""Readings for the limits of a cell's check, on the card: the program on
many seeds, the control, and the planted faults (mp3bench/faults.py).

    python3 benchmark/calibrate.py --workload <config>.<traffic> \
        --seeds 11,12,... [--calls 2] [--control 3] [--faults 3]

One process for all seeds. For each seed the cell's inputs are made, its
own call runs --calls times at the cell's own load (the first seed warms
up first), and the check's numbers are read on the same sample of streams
a run keeps. On the first --control seeds the control is put in the
program's place (each entry's control(): the reference one precision
below the program's for a decode, the program one bitrate below for an
encode, each for its half of a transcode); on the first --faults seeds each fault that applies is planted
and read. One JSON line a reading. The benchmark's own runs never run
this.
"""
import os
import sys
import time

T0 = time.perf_counter()
BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
os.environ["MP3TPU_TORCH_BUILD_DIR"] = os.path.join(ROOT, "build", "mp3tpu_torch")
sys.path[:0] = [BENCH, os.path.join(ROOT, "src")]


def main(argv) -> int:
    import argparse
    import json
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--calls", type=int, default=2)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    a = p.parse_args(argv)
    from mp3bench import faults, spec
    from mp3bench.main import Calls, Sampler, _counters
    cell = spec.load_cell(a.workload)
    entry = spec.load_entry(cell.entry)
    seeds = [int(s) for s in a.seeds.split(",")]
    warmed = False

    def reading(seed, work, kind):
        calls = Calls(cell, work, "cuda")
        nonlocal warmed
        if not warmed:
            calls.warm(cell.traffic["warmup"])
            warmed = True
        sampler = Sampler(cell.traffic["check_streams"], seed)
        f0 = _counters(calls.m)
        win = calls.window(sampler, n_calls=a.calls)
        numbers = calls.check(sampler, cell, win["failed"],
                              _counters(calls.m) - f0)
        print(json.dumps({"workload": cell.name, "seed": seed, "kind": kind,
                          "numbers": numbers, "walls": win["walls"]}),
              flush=True)
        return calls, sampler

    for n, seed in enumerate(seeds):
        work = entry.prepare(cell, seed)
        calls, sampler = reading(seed, work, "program")
        if n < a.control:
            kept = entry.control(sampler.kept, work, cell, calls.m, "cuda")
            numbers = entry.check(kept, work, cell)
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "kind": "control", "numbers": numbers}),
                  flush=True)
        if n < a.faults:
            for fault in faults.FAULTS:
                if faults.applies(fault, cell.entry):
                    with faults.plant(fault, cell.entry):
                        reading(seed, work, "fault:" + fault)
    print(json.dumps({"done": a.workload, "seconds": time.perf_counter() - T0}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
