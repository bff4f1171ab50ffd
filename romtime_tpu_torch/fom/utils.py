"""Peak utilities for the nonlinearity measure (counterpart of
``romtime_tpu/fom/utils.py``)."""

import numpy as np


def find_first_positive_peak(y, locs):
    """First positive, non-vanishing peak and its successor."""
    peaks = y[locs]

    not_zero = ~np.isclose(peaks, 0.0, rtol=1e-3, atol=1e-3)
    positive = peaks > 0.0

    mask = not_zero & positive
    idx = np.where(mask)[0][0]

    return locs[idx], locs[idx + 1]


def compute_time_between_peaks(ts, indices):
    """Time separation between two peak indices."""
    return ts[indices[1]] - ts[indices[0]]
