"""Percent of encode_batch's streams whose block-type labels were decided
from the device's float64 sub-block energies: the items (streams) of the
program's mp3tpu.encode.labels spans with the outcome device over those of
both outcomes (device, host), totals over the window's calls
(MP3TPU_SPANS=1; utils.profiling.TOTALS after each call, cleared as the
window opens). None where the program has no such span."""
from mp3bench.spans import instrument, window_totals  # noqa: F401


def read(ctx):
    got = window_totals(ctx)
    if not got:
        return None
    streams = {o: got[0].get(f"mp3tpu.encode.labels/{o}", {}).get("items", 0)
               for o in ("device", "host")}
    total = streams["device"] + streams["host"]
    return 100.0 * streams["device"] / total if total else None
