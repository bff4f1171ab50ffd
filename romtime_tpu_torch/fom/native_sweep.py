"""The native float64 piston sweep (counterpart of
``romtime_tpu/fom/native_sweep.py``): the eligible f64 ``solve()`` runs
the C++ loop of ``csrc/host/fom_piston.cpp`` on the host instead of the
eager torch loop, which pays a few hundred small launches a step.

The loop takes per-step scalars (the ALE scale, L̇/L, the Dirichlet value
and its rate) evaluated here from the problem's callables, so every
piston-family problem definition rides it; the spatial algebra (banded P1
assembly, the one-sided lifting, BDF-2, the trilinear snapshot capture)
is the eager loop's, held against it at 1e-12 relative in the tests.
``ROMTIME_NATIVE_FOM=0`` keeps every solve on the eager loop.
"""

import os

import numpy as np
import torch

from .. import native
from ..conventions import BDF, OneDimensionalBurgersConventions


def _eligible(fom):
    """Only the exact shipped piston physics takes the native loop: a
    subclass overriding any operator falls back to the eager loop rather
    than inherit the closed-form kernel."""
    from .nonlinear import OneDimensionalBurgers

    return (
        type(fom) is OneDimensionalBurgers
        and os.environ.get("ROMTIME_NATIVE_FOM", "1") != "0"
        and fom.is_setup
        and int(fom.degrees) == 1
        and fom.BDF_SCHEME == BDF.TWO
        and fom.forcing_term is None
        and fom.exact_solution is None
        and not fom.project_u0
        and fom.Lt is not None
        and fom.dLt_dt is not None
        and fom.dirichlet is not None
        and fom.B0 not in fom.dirichlet          # right-only Dirichlet
        and fom.BL in fom.dirichlet
        and getattr(fom, "_nonlinear_topology", None) is not None
    )


def outputs_native(fom, mu):
    """Run the native piston loop for the μ dict ``mu``; return the
    ``_solve_impl`` output dict (float64 tensors on the FOM's compute
    device: ``uh``, ``uc``, ``x``, ``t``, ``nonlinear_data``,
    ``probes``), or None where the FOM is not eligible."""
    if not _eligible(fom):
        return None
    f64 = torch.float64
    mesh = fom.mesh
    nt = int(fom.domain[fom.NT])
    nx = int(fom.domain[fom.NX])
    L0 = float(fom.domain[fom.L0])
    dt = float(fom.dt)

    ts = torch.arange(1, nt + 1, dtype=f64) * dt
    mu_t = {k: torch.tensor(float(v), dtype=f64) for k, v in mu.items()}
    s_arr = fom.Lt(t=ts, **mu_t).to(f64)
    r_arr = fom.dLt_dt(t=ts, **mu_t).to(f64) / s_arr
    L_arr = L0 * s_arr
    # The piston's one-sided lifting bL(t, L) and its rate (its lifting
    # passes dLt_dt = 0, fom/nonlinear.py create_lifting_operator).
    bL_arr = torch.as_tensor(fom._dirichlet_value(fom.BL, mu_t, ts, L_arr),
                             dtype=f64)
    dbL_arr = torch.as_tensor(
        fom._dirichlet_value(fom.DBL_DT, mu_t, ts, L_arr), dtype=f64)

    with torch.no_grad():
        u0 = fom._initial_condition(mu_t).to(f64)
    a0 = float(mu[OneDimensionalBurgersConventions.A0])
    alpha = float(fom.create_diffusion_coefficient(mu))
    b0 = float(fom.nonlinear_coefficient(mu))
    rows, cols = fom._nonlinear_topology

    s_np, bL_np = s_arr.numpy(), bL_arr.numpy()
    uh, nl = native.piston_fom_solve(
        L0, nx, nt, dt, a0, alpha, b0, s_np, r_arr.numpy(), bL_np,
        dbL_arr.numpy(), u0.numpy(), rows, cols)

    x_dofs = np.asarray(mesh.x_dofs, np.float64)
    # g(x_phys) = bL·x_phys/L = bL·x_ref/L0: the ALE scale cancels.
    uc = uh + bL_np[:, None] * (x_dofs / L0)[None, :]
    x_phys = s_np[:, None] * x_dofs[None, :]

    # Probes at material coordinates (scale 1, as the eager loop's
    # _step_outputs), then the piston dof.
    h0 = mesh.h0
    vals = []
    for loc in fom.probe_location:
        e = int(np.clip(np.floor(loc / h0), 0, mesh.ne - 1))
        xi = loc / h0 - e
        vals.append((1.0 - xi) * uc[:, e] + xi * uc[:, e + 1])
    vals.append(uc[:, -1])
    probes = np.stack(vals, axis=1)

    device = fom._compute_device()
    out = {"uh": uh, "uc": uc, "x": x_phys, "t": ts.numpy(),
           "nonlinear_data": nl, "probes": probes}
    return {k: torch.as_tensor(v, dtype=f64, device=device)
            for k, v in out.items()}
