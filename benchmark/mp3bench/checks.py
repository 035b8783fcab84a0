"""The numbers that decide `correct`, each beside its limit.

Every number is one where lower is better, and a run is correct when each
is at or under its limit. Counts of what must never happen (a stream of
the window that did not come back whole, a sampled stream off the
reference's length or rate, a frame the program flagged, a frame off its
format or budget, a length off) are exact: their limit is 0. The others
take theirs from the configuration (what it guarantees: max_lsb,
inexact_pct) or the traffic mix (worst_nsr, set from readings of the
program and of its faults; PERF.md gives them).
"""
from __future__ import annotations

import numpy as np

from . import reference
from .reference.audit import audit

EXACT = ("streams_off", "streams_failed", "decode_faults", "header_off",
         "budget_off", "length_off")


def limit_of(name: str, limits: dict):
    return 0 if name in EXACT else limits[name]


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) in a fixed order."""
    table = {n: {"value": v, "limit": limit_of(n, limits)}
             for n, v in numbers.items()}
    ok = all(t["value"] <= t["limit"] for t in table.values())
    return ok, table


def compare_pcm(got, want: np.ndarray, want_rate: int) -> tuple:
    """(stream off, max |d| in LSB, samples, samples off) of one decoded
    stream against the reference's."""
    if got is None:
        return 1, 0, 0, 0
    pcm, rate = got
    if rate != want_rate or pcm.shape != want.shape:
        return 1, 0, 0, 0
    d = np.abs(pcm.astype(np.int32) - want.astype(np.int32))
    return 0, int(d.max(initial=0)), d.size, int((d != 0).sum())


def decode_numbers(pairs) -> dict:
    """pairs: [(got (pcm, rate) or None, reference pcm, reference rate)]."""
    off = lsb = n = bad = 0
    for got, want, rate in pairs:
        o, m, k, b = compare_pcm(got, want, rate)
        off, lsb, n, bad = off + o, max(lsb, m), n + k, bad + b
    return {"streams_off": off, "max_lsb": lsb,
            "inexact_pct": 100.0 * bad / n if n else 100.0}


def nsr(got: np.ndarray, want: np.ndarray) -> float:
    """Noise-to-signal ratio of got against want, both float [n, ch]."""
    return float(((got - want) ** 2).sum() / max((want ** 2).sum(), 1e-30))


def encoded_numbers(items, fmt: dict, bitrate_kbps: int) -> dict:
    """items: [(MP3 bytes or None, the PCM it should hold, float [n, ch])].
    Each stream is audited as a decoder reads it, decoded by the reference
    and held to its input: header_off, budget_off (reference/audit.py),
    length_off (streams whose gapless length is not the input's),
    worst_nsr (the largest noise-to-signal ratio of a stream, with the
    gapless trim of its own tag)."""
    out = {"streams_off": 0, "header_off": 0, "budget_off": 0,
           "length_off": 0, "worst_nsr": 0.0}
    for data, want in items:
        if not data:
            out["streams_off"] += 1
            continue
        a = audit(data, fmt["sample_rate"], bitrate_kbps, fmt["frame_modes"])
        out["header_off"] += a["header_off"]
        out["budget_off"] += a["budget_off"]
        if a["st"] is None:
            out["worst_nsr"] = max(out["worst_nsr"], 1.0)
            continue
        got = reference.pcm(a["st"], a["info"]) / 32768.0
        if got.shape != want.shape:
            out["length_off"] += 1
            n = min(len(got), len(want))
            got, want = got[:n, :want.shape[1]], want[:n]
        out["worst_nsr"] = max(out["worst_nsr"], nsr(got, want))
    return out
