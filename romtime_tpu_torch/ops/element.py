"""Reference-element tables for 1-D Lagrange elements (counterpart of
``romtime_tpu/ops/element.py``). Static numpy, computed once; the
assembly kernels consume them as small constant tensors."""

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np


def lagrange_nodes(degree):
    """Equispaced Lagrange nodes on [0, 1]."""
    return np.linspace(0.0, 1.0, degree + 1)


def lagrange_coefficients(degree):
    """coeffs[i, k]: coefficient of xi**k in basis i (P_i(node_j)=δ_ij)."""
    nodes = lagrange_nodes(degree)
    vander = np.vander(nodes, degree + 1, increasing=True)
    return np.linalg.solve(vander, np.eye(degree + 1)).T


def polyval_table(coeffs, points):
    """table[q, i] = P_i(points[q])."""
    powers = np.vander(np.asarray(points), coeffs.shape[1], increasing=True)
    return powers @ coeffs.T


def polyder_coeffs(coeffs, order=1):
    out = coeffs
    for _ in range(order):
        k = np.arange(1, out.shape[1])
        out = out[:, 1:] * k[None, :]
    if out.shape[1] == 0:
        out = np.zeros((coeffs.shape[0], 1))
    return out


def gauss_quadrature(npoints):
    """Gauss–Legendre rule mapped to [0, 1]."""
    x, w = np.polynomial.legendre.leggauss(npoints)
    return 0.5 * (x + 1.0), 0.5 * w


@dataclass(frozen=True)
class ElementTables:
    degree: int
    quad_points: np.ndarray = field(repr=False)
    quad_weights: np.ndarray = field(repr=False)
    B0: np.ndarray = field(repr=False)
    B1: np.ndarray = field(repr=False)
    coeffs: np.ndarray = field(repr=False)
    dcoeffs: np.ndarray = field(repr=False)

    def basis_table(self, derivative_order):
        if derivative_order == 0:
            return self.B0
        if derivative_order == 1:
            return self.B1
        raise ValueError(f"Unsupported derivative order {derivative_order}.")


@lru_cache(maxsize=None)
def lagrange_tables(degree, nquad=None):
    """Tables for a degree; 2(degree+1) Gauss points by default (exact for
    every form of the framework, the trilinear term included)."""
    if nquad is None:
        nquad = 2 * (degree + 1)
    xq, wq = gauss_quadrature(nquad)
    coeffs = lagrange_coefficients(degree)
    dcoeffs = polyder_coeffs(coeffs)
    return ElementTables(
        degree=degree, quad_points=xq, quad_weights=wq,
        B0=polyval_table(coeffs, xq), B1=polyval_table(dcoeffs, xq),
        coeffs=coeffs, dcoeffs=dcoeffs,
    )
