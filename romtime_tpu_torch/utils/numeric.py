"""Numeric helpers of the S-ROM estimator (counterpart of
``romtime_tpu/utils/numeric.py:29-60``), host-side numpy."""

import numpy as np


def compute_rom_difference(uN, uN_srom, V_srom):
    """Online error estimator of one step: the RMS-L2 distance between
    the ROM and S-ROM reconstructions, ‖V_srom·(uN_srom − pad(uN))‖₂/√Nh
    (reference ``numeric.py:29-53``). ``uN`` (N,), ``uN_srom`` (N̂,),
    ``V_srom`` (Nh, N̂)."""
    uN = np.asarray(uN)
    uN_srom = np.asarray(uN_srom)
    extra = len(uN_srom) - len(uN)
    uN_padded = np.append(uN, [0.0] * extra)
    diff = uN_srom - uN_padded
    lincomb = np.sum(diff * V_srom, axis=1)
    error = np.linalg.norm(lincomb, ord=2)
    error /= np.sqrt(len(lincomb))
    return error


def time_average(ts, func):
    """Trapezoid time average normalized by the horizon (reference
    ``numeric.py:56-60``)."""
    integral = np.trapezoid(y=func, x=ts)
    return integral / np.max(ts)
