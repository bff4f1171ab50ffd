"""Batched μ-sweeps (counterpart of ``romtime_tpu/parallel/sweep.py``,
``solve_fom_batch``): the FOM's time loop over a whole μ batch at once
on the solver's device, the batch trailing every band and state inside
the loop (``fom/base.py``)."""

import numpy as np
import torch

from ..dtypes import asarray, full_f32_matmul
from ..parameters import parameters_to_array


def _mu_batch_dict(mus, names=None, device=None):
    """μ as name → (B,) tensors in the compute dtype on ``device``, from a
    dict of arrays or a list of μ dicts (columns in ``names`` order,
    default sorted)."""
    if isinstance(mus, dict):
        return {k: asarray(v, device) for k, v in mus.items()}
    arr, names = parameters_to_array(mus, names)
    return {name: asarray(arr[:, j], device) for j, name in enumerate(names)}


def solve_fom_batch(solver, mus, dilations=None):
    """The FOM sweep over a μ batch on the solver's device (the card
    unless it was built with ``device="cpu"``; without a card that raises).

    ``dilations`` (B,): each μ on its own grid, the final time T·d_b over
    the same nt steps (dt_b = d_b·dt), as a registered cell's training
    set is re-solved (the reference solves each such μ alone,
    ``rom/hrom.py:947-975``); the solver's T is restored after.

    Returns numpy arrays with the leading μ axis, as the reference's
    vmapped sweep: ``uh`` (B, nt, nh), ``uc``, ``x``, ``t`` (B, nt) and
    the solver's extras (``probes``, ``nonlinear_data``; ``uh_lo`` under
    ``dd_sweep``). Contractions run in full float32 (TF32 off): the
    reference pins ``jax.default_matmul_precision("highest")`` after a
    bf16 default took a served fleet from 2.5e-7 to 3.2e-5."""
    device = solver._compute_device()
    batch = _mu_batch_dict(mus, device=device)
    T = solver.domain[solver.T]
    if dilations is not None:
        solver.domain[solver.T] = float(T) * asarray(
            np.asarray(dilations, np.float64), device)
    try:
        with full_f32_matmul(), torch.no_grad():
            outs = solver._solve_impl(batch)
    finally:
        solver.domain[solver.T] = T
    return {k: v.cpu().numpy() for k, v in outs.items()}
