"""Share of the profiled calls' span in which no kernel, copy or memset
ran on the device, percent."""


def read(trace):
    lo, hi = trace.window
    if not trace.device or hi <= lo:
        return None
    return 100.0 * (1.0 - trace.device_busy_us() / (hi - lo))
