"""Arithmetic that several per-layer metrics share."""

from .trace import KERNEL, sweep_role


def roofline_pct(trace, role):
    """100 × the least seconds of the profiled calls' ``role`` launches
    over their device seconds; None where no such launch was profiled.
    Raises where the profiler saw another number of launches than the
    calls made: the bound would then be summed over other work."""
    bounds = [s for r, s in trace.launches if r == role]
    kernels = [d for cat, name, _s, d in trace.device
               if cat == KERNEL and sweep_role(name) == role]
    if not bounds or not kernels:
        return None
    if len(bounds) != len(kernels):
        raise RuntimeError(f"{role}: {len(kernels)} kernels profiled for "
                           f"{len(bounds)} launches")
    return 100.0 * sum(bounds) / (1e-6 * sum(kernels))
