"""K1's share of its roofline, percent: the least time of the profiled
calls' K1 launches (``benchmark/roofline``, from the cell's shapes) over
their summed device time."""

from benchmark.metrics_common import roofline_pct


def read(trace):
    return roofline_pct(trace, "k1")
