"""A torch.profiler trace of a few calls of the cell, reduced to numbers.

capture() runs the calls under torch.profiler (host and CUDA activity),
writes the Chrome trace into a temporary directory, reads it back and
deletes it. reduce() keeps: the traced window (the first call's start to
the last call's end, each call a "bench.call" range), the seconds in which
some kernel, copy or memset ran on the device, the device time by kernel
and by copy direction, and the device's idle time, each stretch of it put
down to the innermost host range (the harness's "bench.*" ranges and the
program's own "mp3tpu.*" annotations) open over it.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CALL = "bench.call"


def clean(name: str) -> str:
    """A kernel's name without its return type, namespace noise and
    arguments."""
    n = name.replace("(anonymous namespace)::", "")
    n = re.sub(r"^void ", "", n)
    depth, cut = 0, len(n)
    for i, ch in enumerate(n):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return n[:cut][:96]


def capture(run_calls) -> dict:
    """reduce() of a trace of run_calls(), which runs the calls, each inside
    a CALL range and ended by a synchronize."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        run_calls()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return reduce(events)


def _union(ivs):
    out = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events) -> dict:
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    host = [e for e in xs if e.get("cat") == "user_annotation"]
    calls = [e for e in host if e["name"] == CALL]
    if not calls:
        raise ValueError("the trace holds no bench.call range")
    w0 = min(e["ts"] for e in calls)
    w1 = max(e["ts"] + e["dur"] for e in calls)
    dev, kernels, copies = [], defaultdict(lambda: [0, 0.0]), defaultdict(lambda: [0, 0.0])
    raw = defaultdict(lambda: [0, 0.0])
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b <= a:
            continue
        dev.append((a, b))
        s = (b - a) * 1e-6
        if e["cat"] == "gpu_memcpy":
            k = copies[e["name"].split()[1] if " " in e["name"] else e["name"]]
        else:
            k = kernels[clean(e["name"])]
            r = raw[e["name"]]
            r[0] += 1
            r[1] += s
        k[0] += 1
        k[1] += s
    busy = _union(dev)
    gaps = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    spans = sorted((e["ts"], e["ts"] + e["dur"], re.sub(r"\[.*\]$", "", e["name"]))
                   for e in host if e["name"] != CALL)
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        # split the gap where a host range opens or closes inside it, and
        # give each piece to the innermost range open over it
        inside = [s for s in spans if s[0] < b and s[1] > a]
        cuts = sorted({a, b} | {t for s in inside for t in s[:2] if a < t < b})
        for x, y in zip(cuts, cuts[1:]):
            m = 0.5 * (x + y)
            inner = [s for s in inside if s[0] <= m < s[1]]
            gaps[max(inner)[2] if inner else "(between ranges)"] += (y - x) * 1e-6
    ops = sorted(([n, v[1]] for n, v in kernels.items()), key=lambda x: -x[1])
    ops += [[f"Memcpy_{n}", v[1]] for n, v in copies.items()]
    ops.sort(key=lambda x: -x[1])
    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "calls": len(calls),
            "kernels": {n: list(v) for n, v in raw.items()},
            "copies": {n: list(v) for n, v in copies.items()},
            "device_ops": ops[:10],
            "idle_gaps": sorted(([n, s] for n, s in gaps.items()),
                                key=lambda x: -x[1])[:10]}
