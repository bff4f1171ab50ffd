"""Frozen P1 assembly of the piston's operator entries (plain PyTorch,
float64 for the reference): the benchmark's own copy of the physics the
served θ tables come from.

The moving-piston gas dynamics on [0, L0·Lt(μ, t)], pulled back to a
uniform reference mesh of ``nx`` cells (h = h0·Lt), "rest" regime:

    Lt = 1 − δ(1 − cos ωt),  L̇t = −ωδ sin ωt
    bL = −δ(ω/a0) sin ωt,    ḃL = −δω(ω/a0) cos ωt   (piston velocity)
    g(x) = bL·x/L, ∇g = bL/L, ġ(x) = ḃL·x/L            (one-sided lifting)
    w(x) = x·L̇t/Lt (mesh velocity), b0 = (γ+1)/2·a0, α = viscosity

and the five forms a served θ row samples at its DEIM entries:

    mass               ∫ φj φi
    stiffness          ∫ α φj′ φi′
    convection         ∫ −(a0 + w) φj′ φi
    nonlinear_lifting  ∫ b0·g φj′ φi + b0·∇g φj φi
    rhs_vec            ∫ (−(ġ + b0·g·∇g) + (a0 + w)·∇g) φi − α∇g φi′

(i test, j trial). Rows pinned by the Dirichlet condition at x = L take
the identity row (matrix) or 0 (vector). Each integral is a 3-point
Gauss-Legendre sum per element, exact for these polynomial integrands.
"""

import numpy as np
import torch

#: The matrix and vector sources, in the order a payload lists them.
MATRIX_SOURCES = ("mass", "stiffness", "convection", "nonlinear_lifting")
VECTOR_SOURCES = ("rhs_vec",)
SOURCES = ("mass", "stiffness", "rhs_vec", "convection",
           "nonlinear_lifting")

_XI, _W = np.polynomial.legendre.leggauss(3)
QUAD_POINTS = 0.5 * (_XI + 1.0)
QUAD_WEIGHTS = 0.5 * _W


def piston_fields(mu, t, L0, gamma):
    """The per-(t, μ) scalars of the rest regime; ``mu`` maps a0, omega,
    delta to (b,) tensors, ``t`` is (T, b) (or broadcastable)."""
    a0, om, de = mu["a0"], mu["omega"], mu["delta"]
    s = 1.0 - de * (1.0 - torch.cos(om * t))
    ds = -om * de * torch.sin(om * t)
    bL = -de * (om / a0) * torch.sin(om * t)
    dbL = -de * om * (om / a0) * torch.cos(om * t)
    L = L0 * s
    return dict(a0=a0 + 0.0 * t, s=s, ds=ds, L=L, bL=bL, dbL=dbL,
                b0=(gamma + 1.0) / 2.0 * a0 + 0.0 * t)


def _basis(order, local, like):
    """φ_local (order 0) or dφ_local/dξ (order 1) at the quadrature
    points, (Q,) in ``like``'s dtype and device."""
    xi = torch.as_tensor(QUAD_POINTS, dtype=like.dtype, device=like.device)
    if order == 0:
        return 1.0 - xi if local == 0 else xi
    return torch.full_like(xi, -1.0 if local == 0 else 1.0)


def _terms(source, f, x, viscosity):
    """[(trial order a or None for a vector, test order b, coefficient
    (Q, T, b))] of ``source`` at physical points ``x``."""
    one = torch.ones_like(x)
    a0, s, ds, L = f["a0"], f["s"], f["ds"], f["L"]
    bL, dbL, b0 = f["bL"], f["dbL"], f["b0"]
    w = x * ds / s
    grad_g = bL / L
    if source == "mass":
        return [(0, 0, one)]
    if source == "stiffness":
        return [(1, 1, viscosity * one)]
    if source == "convection":
        return [(1, 0, -(a0 + w))]
    if source == "nonlinear_lifting":
        return [(1, 0, b0 * bL * x / L), (0, 0, b0 * grad_g * one)]
    if source == "rhs_vec":
        g = bL * x / L
        dg = dbL * x / L
        return [(None, 0, -(dg + b0 * g * grad_g) + (a0 + w) * grad_g),
                (None, 1, -viscosity * grad_g * one)]
    raise ValueError(f"unknown source {source!r}")


def entries(source, dofs, mu, t, nx, L0=1.0, gamma=1.4, viscosity=1e-10):
    """The assembled values of ``source`` at its DEIM entries ``dofs``
    ((k, 2) rows and columns of a matrix source, (k, 1) or (k,) dofs of a
    vector source) for the μ lanes ``mu`` (name → (b,) float64 tensors)
    at the times ``t`` ((T, b) or (T, 1)): a (k, T, b) tensor in their
    dtype (float64 for the reference)."""
    dofs = np.asarray(dofs).reshape(len(dofs), -1)
    nh = nx + 1
    h0 = L0 / nx
    f = piston_fields(mu, t, L0, gamma)
    s = f["s"]
    wq = torch.as_tensor(QUAD_WEIGHTS, dtype=s.dtype, device=s.device)
    xi = torch.as_tensor(QUAD_POINTS, dtype=s.dtype, device=s.device)
    out = []
    for entry in dofs:
        row = int(entry[0])
        col = int(entry[1]) if len(entry) > 1 else None
        vector = col is None
        if row == nh - 1:          # the Dirichlet row at the piston
            out.append(torch.zeros_like(s) + (0.0 if vector or col != row
                                              else 1.0))
            continue
        cells = [e for e in (row - 1, row) if 0 <= e < nx]
        if not vector:
            cells = [e for e in cells if 0 <= col - e <= 1]
        total = torch.zeros_like(s)
        for e in cells:
            x = ((e + xi)[:, None, None] * h0) * s[None]     # (Q, T, b)
            h = h0 * s
            for a, b, c in _terms(source, f, x, viscosity):
                test = _basis(b, row - e, s)
                shape = test
                power = 1 - b
                if a is not None:
                    shape = shape * _basis(a, col - e, s)
                    power -= a
                total = total + (h ** power) * torch.einsum(
                    "q,q,qtb->tb", wq, shape, c)
        out.append(total)
    return torch.stack(out)
