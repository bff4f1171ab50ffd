"""Mach bands of the piston's μ box: the piston Mach number δω/a0, the
equal-width band edges over the box and the band of each μ (values at
or beyond the outer edges go to the outer bands)."""

import numpy as np


def mach(a0, omega, delta):
    """δω/a0, elementwise on numbers or arrays."""
    return np.asarray(delta) * np.asarray(omega) / np.asarray(a0)


def band_edges(box, bands):
    """``bands`` + 1 equal-width edges from δ_min·ω_min/a0_max to
    δ_max·ω_max/a0_min of ``box`` (name → (lo, hi))."""
    lo = box["delta"][0] * box["omega"][0] / box["a0"][1]
    hi = box["delta"][1] * box["omega"][1] / box["a0"][0]
    return np.linspace(lo, hi, bands + 1)


def band_of(edges, m):
    """Band index of Mach number(s) ``m``: the last edge at or below it,
    clipped to the bands."""
    idx = np.searchsorted(np.asarray(edges), np.asarray(m), side="right") - 1
    return np.clip(idx, 0, len(edges) - 2)
