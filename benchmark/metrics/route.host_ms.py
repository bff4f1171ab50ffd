"""Host milliseconds a routed call spends outside its per-cell sweeps:
grouping the μ by Mach cell, padding each sub-batch, merging the rows
(the call's wall less the spans of its ``sweep_fn`` calls), mean over
the window's calls outside the profiler."""


def read(trace):
    calls = [c for c in trace.calls if "cells" in c and not c["profiled"]]
    if not calls:
        return None
    rest = [c["wall_s"] - sum(s for _lanes, s in c["cells"]) for c in calls]
    return 1e3 * sum(rest) / len(rest)
