"""2-D heat equation on a structured grid (counterpart of
``examples/heat_2d.py``).

Tensor-product P1 elements on a uniform grid give Kronecker operators
M = M1⊗M1, A = A1⊗M1 + M1⊗A1 (field form: MG = M1 G M1ᵀ,
AG = A1 G M1ᵀ + M1 G A1ᵀ). The implicit-Euler step diagonalizes in the
1-D generalized eigenbasis of (A1, M1), so the whole time loop is dense
matmuls and an elementwise scale on the device, no sparse solver.

Manufactured problem: u_e = 1 + x² + β y² + α t, u_t = Δu + f,
f = α − 2 − 2β, with Dirichlet data u_e on the boundary. Writing
u = w + g with g = u_e, the homogeneous variable w solves the heat
equation with zero data, so the scheme tracks u_e to solver precision.

    python -m romtime_tpu_torch.examples.heat_2d [--device cpu]

Everything runs in float64, the Cholesky and ``eigh`` on the device.
"""

import argparse

import numpy as np
import torch

from ..ops.assembly import assemble_bilinear_band, band_to_dense
from ..ops.mesh import Mesh1D
from ..utils.cli import add_device_argument, resolve_device


def one_dimensional_operators(nx, device="cuda"):
    """Dense 1-D mass and stiffness (no BCs) on [0,1] and the dof
    coordinates, float64 on ``device``."""
    device = resolve_device(device)
    mesh = Mesh1D(L0=1.0, nx=nx, degree=1)
    ones = torch.ones((mesh.ne, len(mesh.tables.quad_points)),
                      dtype=torch.float64, device=device)
    M1 = band_to_dense(assemble_bilinear_band(mesh, ones, 0, 0, mesh.h0), 1)
    A1 = band_to_dense(assemble_bilinear_band(mesh, ones, 1, 1, mesh.h0), 1)
    x = torch.as_tensor(mesh.x_dofs, dtype=torch.float64, device=device)
    return M1, A1, x


def solve_heat_2d(nx=32, nt=50, tf=2.0, alpha=3.0, beta=1.2,
                  device="cuda"):
    """Implicit Euler over ``nt`` steps to ``tf``: (times, max|u − u_e|
    per step, the final field u (nx+1, nx+1)), numpy."""
    M1, A1, x = one_dimensional_operators(nx, device)
    dt = tf / nt

    def ue(X, Y, t):
        return 1.0 + X ** 2 + beta * Y ** 2 + alpha * t

    f_const = alpha - 2.0 - 2.0 * beta
    X, Y = torch.meshgrid(x, x, indexing="ij")

    # Interior-row (full-column) operator blocks for the lifting couplings
    M1f, A1f = M1[1:-1, :], A1[1:-1, :]
    Mi, Ai = M1[1:-1, 1:-1], A1[1:-1, 1:-1]

    # Generalized eigenbasis of (A1, M1) on the interior: A1 φ = λ M1 φ
    # via Cholesky congruence, so the Kronecker step solve is diagonal.
    L = torch.linalg.cholesky(Mi)
    Linv = torch.linalg.inv(L)
    lam, Q = torch.linalg.eigh(Linv @ Ai @ Linv.T)
    P = Linv.T @ Q  # M-orthonormal: PᵀMiP = I, (MiP)⁻¹ = Pᵀ

    denom = 1.0 + dt * (lam[:, None] + lam[None, :])

    # Load vector of a constant: ∫ c φ_i φ_j factorizes over axes.
    m1 = M1 @ torch.ones_like(x)
    load = torch.outer(m1[1:-1], m1[1:-1])

    # The JAX example jits this step; here it is a plain function on
    # tensors, every operation on the device.
    def step(w_int, t_new):
        """(M + dt A) w⁺ = M wⁿ + dt (F − A g⁺ − M ġ⁺), interior rows."""
        G = ue(X, Y, t_new)
        F_int = f_const * load
        Ag_int = A1f @ G @ M1f.T + M1f @ G @ A1f.T
        Mgdot_int = alpha * load
        rhs = Mi @ w_int @ Mi.T + dt * (F_int - Ag_int - Mgdot_int)
        # With W = P Ŵ Pᵀ the system becomes Mi P (Ŵ∘denom) PᵀMi = rhs
        # and (MiP)⁻¹ = Pᵀ, so Ŵ = (Pᵀ rhs P) / denom.
        w_hat = (P.T @ rhs @ P) / denom
        return P @ w_hat @ P.T

    n = x.shape[0]
    w = torch.zeros((n - 2, n - 2), dtype=torch.float64, device=x.device)
    errors, ts = [], []
    for k in range(nt):
        t_new = (k + 1) * dt
        w = step(w, t_new)
        exact = ue(X, Y, t_new)
        u = exact.clone()
        u[1:-1, 1:-1] += w
        errors.append((u - exact).abs().max())
        ts.append(t_new)
    return (np.array(ts), torch.stack(errors).cpu().numpy(),
            u.cpu().numpy())


def main(argv=None):
    parser = add_device_argument(argparse.ArgumentParser(description=__doc__))
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    for nx in (16, 32):
        _ts, errors, _u = solve_heat_2d(nx=nx, nt=50, device=device)
        print(f"nx={nx:3d}  max|u - u_e| at t=tf: {errors[-1]:.3e}  "
              f"(max over run: {errors.max():.3e})")


if __name__ == "__main__":
    main()
