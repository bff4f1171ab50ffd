"""Poisson tutorial (counterpart of ``examples/poisson_tutorial.py``):
a steady 1-D solve with a manufactured solution through the port's
``ops`` on the device, then a parametrized POD demonstration.

    python -m romtime_tpu_torch.examples.poisson_tutorial [--device cpu]

Everything runs in float64 (the JAX example's ``jax_enable_x64``).
"""

import argparse
import math

import numpy as np
import torch

from ..ops.assembly import (
    apply_dirichlet_band,
    apply_dirichlet_vector,
    assemble_bilinear_band,
    assemble_linear_vector,
    norm_L2,
)
from ..ops.linalg import solve_banded
from ..ops.mesh import Mesh1D
from ..rom.pod import orth
from ..utils.cli import add_device_argument, resolve_device

#: The certification grids and the POD family (the JAX example's).
CERTIFY_NX = (16, 64, 256)
FAMILY_NX = 128
FAMILY_ALPHAS = np.linspace(0.5, 2.0, 12)
UNSEEN_ALPHA = 1.234


def solve_poisson(nx, alpha, device="cuda"):
    """-alpha u'' = f on [0,1], u(0)=u(1)=0, f = pi^2 sin(pi x), P1 on
    ``device``: (mesh, u (nh,) float64)."""
    device = resolve_device(device)
    mesh = Mesh1D(L0=1.0, nx=nx, degree=1)
    xq = torch.as_tensor(mesh.xq_ref, dtype=torch.float64, device=device)

    A = assemble_bilinear_band(mesh, alpha * torch.ones_like(xq), 1, 1,
                               mesh.h0)
    f = assemble_linear_vector(mesh, math.pi ** 2 * torch.sin(math.pi * xq),
                               0, mesh.h0)

    dirichlet = (0, mesh.nh - 1)
    A = apply_dirichlet_band(A, dirichlet, mesh.degree)
    f = apply_dirichlet_vector(f, dirichlet)
    return mesh, solve_banded(A, f, mesh.degree)


def certify(device="cuda", grids=CERTIFY_NX):
    """alpha = 1 (u = sin(pi x)): {nx: (u, L2 error against the
    interpolant)}, u as numpy."""
    out = {}
    for nx in grids:
        mesh, u = solve_poisson(nx, alpha=1.0, device=device)
        ue = torch.sin(math.pi * mesh.on(u.dtype, u.device).x)
        out[nx] = (u.cpu().numpy(), float(norm_L2(u - ue, mesh)))
    return out


def pod_family(device="cuda"):
    """The parametrized family u(x; alpha) = sin(pi x)/alpha is rank 1:
    POD of its snapshots (the port's ``orth``) and the reduced
    reconstruction at an unseen alpha. Returns {"basis", "sigmas",
    "reconstruction_rel"}."""
    snapshots = np.array([
        solve_poisson(FAMILY_NX, float(a), device)[1].cpu().numpy()
        for a in FAMILY_ALPHAS]).T                       # (nh, n_mu)
    basis, sigmas, _energy = orth(snapshots)
    u_new = solve_poisson(FAMILY_NX, UNSEEN_ALPHA, device)[1].cpu().numpy()
    reconstruction = basis @ (basis.T @ u_new)
    rel = np.linalg.norm(reconstruction - u_new) / np.linalg.norm(u_new)
    return {"basis": basis, "sigmas": sigmas, "reconstruction_rel": rel}


def main(argv=None):
    parser = add_device_argument(argparse.ArgumentParser(description=__doc__))
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    # 1) Certify against the exact solution (alpha = 1: u = sin(pi x)).
    for nx, (_u, err) in certify(device).items():
        print(f"nx={nx:4d}  L2 error vs interpolant = {err:.3e} "
              f"(nodally exact)")

    # 2) Parametrized family: POD finds it with one mode; the reduced
    #    solve at an unseen alpha is exact.
    pod = pod_family(device)
    sigmas = pod["sigmas"]
    print(f"\nPOD of the parametrized family: {pod['basis'].shape[1]} "
          f"mode(s), sigma_2/sigma_1 = {sigmas[1] / sigmas[0]:.2e}")
    print(f"1-mode reconstruction error at unseen alpha: "
          f"{pod['reconstruction_rel']:.2e}")


if __name__ == "__main__":
    main()
