"""Device-to-host copy milliseconds per call (the served probes and
states fetched to the host), from the profiler."""

from benchmark.trace import MEMCPY


def read(trace):
    if not trace.profiled_calls or not trace.device:
        return None
    us = sum(d for cat, name, _s, d in trace.device
             if cat == MEMCPY and "DtoH" in name)
    return 1e-3 * us / trace.profiled_calls
