"""Device milliseconds per call of every kernel but the sweep kernels
(K1, K4) and the copies: θ prep, table materialization, the carry's
transfers and the wrappers' own operations, from the profiler."""

from benchmark.trace import KERNEL, sweep_role


def read(trace):
    if not trace.profiled_calls or not trace.device:
        return None
    us = sum(d for cat, name, _s, d in trace.device
             if cat == KERNEL and sweep_role(name) is None)
    return 1e-3 * us / trace.profiled_calls
