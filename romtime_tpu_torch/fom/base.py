"""Abstract 1-D full-order solver: the serving subset (counterpart of
``romtime_tpu/fom/base.py``).

Serving evaluates operators only at DEIM entries, over a whole table of
(time, μ-lane) points at once. So this port keeps the gathered-entry
assembly, the ALE pull-back scale and the lifting, and nothing of the
banded FOM time loop. Coefficients and scales carry any trailing batch
shape. An empty or missing entry list raises: serving must never fall
back to assembling the full band (the reference takes ``if entries:``
as false there and returns a full banded operator).
"""

import torch

from ..conventions import BDF, BoundaryConditions, Domain
from ..ops.assembly import (
    apply_entry_dirichlet,
    assemble_bilinear_entries,
    assemble_linear_entries,
)
from ..ops.mesh import Mesh1D


class OneDimensionalSolver:
    """FEM solver for 1-D parametrized problems on (possibly) moving
    domains; entry assembly only."""

    DIRICHLET_ENTRY = 1.0
    DIRICHLET_VALUE = 0.0

    NX = Domain.NX
    NT = Domain.NT
    L0 = Domain.L0
    T = Domain.T

    B0 = BoundaryConditions.B0
    BL = BoundaryConditions.BL
    DB0_DT = BoundaryConditions.DB0_DT
    DBL_DT = BoundaryConditions.DBL_DT

    BDF_SCHEME = BDF.TWO

    def __init__(self, domain, dirichlet=None, Lt=None, dLt_dt=None,
                 degrees=1, bdf_scheme=None):
        self.domain = dict(domain)
        self.dirichlet = dict(dirichlet) if dirichlet else None
        self.Lt = Lt
        self.dLt_dt = dLt_dt
        self.degrees = int(degrees)
        if bdf_scheme is not None:
            self.BDF_SCHEME = str(bdf_scheme)
        self.mesh = Mesh1D(L0=float(self.domain[self.L0]),
                           nx=int(self.domain[self.NX]),
                           degree=self.degrees)
        self._entry_map_cache = {}

    @property
    def dt(self):
        return self.domain[self.T] / self.domain[self.NT]

    @property
    def dirichlet_dofs(self):
        """Dofs pinned by the Dirichlet convention, from which boundary
        values the problem defines (left ``b0``, right ``bL``)."""
        if self.dirichlet is None:
            return (0, self.mesh.nh - 1)
        dofs = []
        if self.B0 in self.dirichlet:
            dofs.append(0)
        if self.BL in self.dirichlet:
            dofs.append(self.mesh.nh - 1)
        return tuple(dofs)

    def scale_factor(self, mu, t):
        """ALE pull-back factor Lt(μ, t), with the batch shape of μ and t.
        Every operator integrates over the moving domain."""
        if self.Lt is None:
            raise ValueError("the serving assembly needs the domain motion Lt")
        return self.Lt(t=t, **mu)

    # ------------------------------------------------------------------
    # Entry assembly drivers
    # ------------------------------------------------------------------

    def _entry_map(self, entries):
        if entries is None or len(entries) == 0:
            raise ValueError(
                "serving assembles at DEIM entries only; got an empty "
                "entry list (a reductor with no interpolation dofs)")
        key = tuple(tuple(int(v) for v in e) for e in entries)
        cached = self._entry_map_cache.get(key)
        if cached is None:
            cached = self.mesh.build_entry_map(
                key, dirichlet_dofs=self.dirichlet_dofs,
                dirichlet_entry=self.DIRICHLET_ENTRY,
                dirichlet_value=self.DIRICHLET_VALUE)
            self._entry_map_cache[key] = cached
        return cached

    def _xq(self, scale, elements):
        """Physical quadrature coordinates of ``elements``, with the
        scale's batch shape trailing: (n_el, Q, *scale.shape)."""
        scale = torch.as_tensor(scale)
        xq = torch.as_tensor(self.mesh.xq_ref[elements], dtype=scale.dtype,
                             device=scale.device)
        return xq.reshape(xq.shape + (1,) * scale.ndim) * scale

    def _assemble_matrix(self, terms, mu, t, entries):
        """Sum of bilinear terms (a, b, coeff(x, elements)) at ``entries``."""
        emap = self._entry_map(entries)
        scale = self.scale_factor(mu, t)
        h = self.mesh.h0 * scale
        xq = self._xq(scale, emap.elements)
        values = sum(
            assemble_bilinear_entries(self.mesh, emap, c(xq, emap.elements),
                                      a, b, h)
            for (a, b, c) in terms
        )
        return apply_entry_dirichlet(values, emap)

    def _assemble_vector(self, terms, mu, t, entries):
        """Sum of linear terms (b, coeff(x, elements)) at ``entries``."""
        emap = self._entry_map(entries)
        scale = self.scale_factor(mu, t)
        h = self.mesh.h0 * scale
        xq = self._xq(scale, emap.elements)
        values = sum(
            assemble_linear_entries(self.mesh, emap, c(xq, emap.elements),
                                    b, h)
            for (b, c) in terms
        )
        return apply_entry_dirichlet(values, emap)

    def assemble_local(self, form_terms, entries, mu=None, t=None,
                       is_vector=False):
        """Per-entry assembly API of the reference."""
        if is_vector:
            return self._assemble_vector(form_terms, mu, t, entries)
        return self._assemble_matrix(form_terms, mu, t, entries)

    def assemble_mass(self, mu, t, entries=None):
        """Mass operator u·v."""
        one = lambda x, elements: torch.ones_like(x)
        return self._assemble_matrix([(0, 0, one)], mu, t, entries)

    # ------------------------------------------------------------------
    # Lifting
    # ------------------------------------------------------------------
    def _dirichlet_value(self, key, mu, t, L, dLt_dt=0.0):
        fn = self.dirichlet[key]
        if callable(fn):
            return fn(t=t, L=L, dLt_dt=dLt_dt, **mu)
        return fn

    def create_lifting_operator(self, mu, t, L, only_g=False):
        """Two-sided linear lifting g, dg/dt, ∇g as callables of x."""
        b0 = self._dirichlet_value(self.B0, mu, t, L)
        bL = self._dirichlet_value(self.BL, mu, t, L)

        def g(x):
            return bL * (x / L) + b0 * (L - x) / L

        if only_g:
            return g
        db0 = self._dirichlet_value(self.DB0_DT, mu, t, L)
        dbL = self._dirichlet_value(self.DBL_DT, mu, t, L)

        def dg_dt(x):
            return dbL * (x / L) + db0 * (L - x) / L

        return g, dg_dt, (bL - b0) / L
