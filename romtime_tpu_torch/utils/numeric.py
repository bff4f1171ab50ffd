"""Numeric helpers (counterpart of ``romtime_tpu/utils/numeric.py``),
host-side numpy."""

import numpy as np

ZERO_TOLERANCE = 1e-15


def project_dense(Ah, V):
    """The Galerkin projection A_N = Vᵀ·A_h·V of any ``Ah`` that supports
    ``@`` (reference ``numeric.py:8-14``)."""
    return V.T @ (Ah @ V)


def eliminate_zeros_vector(values, tolerance=ZERO_TOLERANCE):
    """The keep-mask of a vector of stored nonzeros: False where a value
    is zero at rtol = atol = ``tolerance`` (reference
    ``numeric.py:17-26``)."""
    values = np.asarray(values)
    return ~np.isclose(values, 0.0, rtol=tolerance, atol=tolerance)


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


def singular_to_pod_error(sigmas):
    """The POD truncation error √(Σ_{j>i} σ_j²) after each mode i
    (reference ``numeric.py:63-71``); the last entry is guarded against a
    tiny negative round-off before the root."""
    eigenvalues = np.power(sigmas, 2)
    pod_error = np.sum(eigenvalues) - np.cumsum(eigenvalues)
    return np.sqrt(np.maximum(pod_error, 0.0))


def singular_to_energy(sigmas):
    """The cumulative energy fraction of a singular-value decay
    (reference ``numeric.py:74-79``)."""
    eigenvalues = np.power(sigmas, 2)
    return np.cumsum(eigenvalues) / np.sum(eigenvalues)
