"""95th percentile of one call's wall time, μ on the host to probes and
final states on the host, over the window's calls outside the profiler,
milliseconds (the end-to-end ``call_p95_ms`` of a cell whose card the
host leaves idle most of the time, where the host paces the tail)."""

import statistics


def read(trace):
    walls = [1e3 * c["wall_s"] for c in trace.calls if not c["profiled"]]
    if len(walls) < 20:
        return None
    return statistics.quantiles(walls, n=20, method="inclusive")[18]
