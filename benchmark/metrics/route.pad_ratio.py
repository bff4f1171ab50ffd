"""Lanes swept per μ served: the sum of the sub-batch lengths the router
hands its per-cell sweeps over the μ of the calls (a count; 1.0 when
every call falls in one Mach cell)."""


def read(trace):
    calls = [c for c in trace.calls if "cells" in c]
    mu = sum(c["mu"] for c in calls)
    if not mu:
        return None
    return sum(lanes for c in calls for lanes, _s in c["cells"]) / mu
