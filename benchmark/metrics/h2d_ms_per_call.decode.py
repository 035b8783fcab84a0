"""Milliseconds of host-to-device copies a call: the device time of every
Memcpy HtoD in the traced calls, over their number."""


def read(ctx):
    tr = ctx.trace
    if not tr or not tr["calls"] or "HtoD" not in tr["copies"]:
        return None
    return 1e3 * tr["copies"]["HtoD"][1] / tr["calls"]
