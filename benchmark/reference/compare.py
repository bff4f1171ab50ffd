"""The comparison that decides ``correct``: served rows against the
reference's rows of the same μ (:mod:`.sweep`), one number per quantity,
each held to its limit.

- ``probe_gap``: the largest, over the rows, of max |p − p_ref| over the
  row's steps and both probes, divided by max |p_ref| of the row;
- ``state_gap``: the largest, over the rows, of max |u − u_ref| of the
  final reduced state, divided by the row's state size over its whole
  march (max over steps and modes of |u_ref|): the final state itself
  can come near zero for some μ, and a gap divided by it would swing
  with that, not with the error;
- ``state_gap_median``: the median over the rows of that per-row state
  gap. The worst row catches a fault in a few lanes; the median, steady
  from seed to seed, catches a loss of precision on every lane, such as
  a state carried in plain float32 instead of double-float32, which the
  worst row alone cannot tell from the rounding of a sound run;
- ``guard_flips``: rows of a registered cell whose extrapolation flag
  differs from the reference's, leaving out rows whose guard distance
  lies within ``GUARD_TIE`` (relative) of the threshold, where float32
  rounding of μ may decide either way; an exact comparison, limit 0.
"""

import numpy as np
import torch

from .sweep import sweep_rows

GUARD_TIE = 1e-5


def row_gap(got, want):
    """max |got − want| / max |want| per row (leading axis)."""
    got = np.asarray(got, np.float64).reshape(len(got), -1)
    want = np.asarray(want, np.float64).reshape(len(want), -1)
    scale = np.maximum(np.abs(want).max(axis=1), 1e-300)
    return np.abs(got - want).max(axis=1) / scale


def reference_rows(payload, config, groups, rows, dtype=torch.float64,
                   device="cpu", tf32_products=False):
    """The reference's outputs for the served rows ``rows`` (a dict of
    per-row arrays: ``mu`` name → (n,), and ``group`` (n,) the cell of
    each), one sweep per cell (:func:`.sweep.sweep_rows`, its products in
    TF32 with ``tf32_products``): name → per-row numpy arrays in row
    order (``uN_final`` a list when the cells differ in N)."""
    n = len(groups)
    out = {"probes": [None] * n, "uN_final": [None] * n,
           "state_size": np.ones(n), "dil": np.ones(n),
           "dil_oor": np.zeros(n), "guard_margin": np.full(n, np.inf)}
    for c in sorted(set(groups.tolist())):
        idx = np.nonzero(groups == c)[0]
        ref = sweep_rows(payload, config, int(c),
                         {k: v[idx] for k, v in rows.items()},
                         dtype=dtype, device=device,
                         tf32_products=tf32_products)
        for key, val in ref.items():
            val = val.detach().to("cpu", torch.float64).numpy()
            for j, i in enumerate(idx):
                out[key][i] = val[j]
    return out


def compare(served, ref, registered_rows):
    """The numbers compared: name → value (:mod:`module doc <.compare>`).
    ``served`` and ``ref`` hold per-row ``probes`` and ``uN_final``, and
    ``dil_oor`` where ``registered_rows`` (a boolean mask) is set."""
    n = len(served["probes"])
    probe = max(row_gap([served["probes"][i]], [ref["probes"][i]])[0]
                for i in range(n))
    state = [float(np.abs(np.asarray(served["uN_final"][i], np.float64)
                          - ref["uN_final"][i]).max())
             / ref["state_size"][i] for i in range(n)]
    numbers = {"probe_gap": float(probe), "state_gap": float(max(state)),
               "state_gap_median": float(np.median(state))}
    mask = np.asarray(registered_rows, bool)
    if mask.any():
        decided = mask & (np.asarray(ref["guard_margin"]) > GUARD_TIE)
        flips = (np.asarray(served["dil_oor"])[decided]
                 != np.asarray(ref["dil_oor"])[decided])
        numbers["guard_flips"] = int(flips.sum())
    return numbers


def judge(numbers, limits):
    """(all within limits, {name: {"value", "limit"}}); a number with no
    limit, or a non-finite number, fails."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is None or not np.isfinite(value) or value > limit:
            ok = False
    return ok, checks
