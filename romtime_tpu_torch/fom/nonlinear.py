"""One-dimensional isentropic gas dynamics (moving-piston Burgers model),
serving subset (counterpart of ``romtime_tpu/fom/nonlinear.py:124-360``):

    u_t + (a0 + w)·u′ + b0·u·u′ + lifting couplings − α·u″ = 0

with right-boundary-only Dirichlet data and a one-sided lifting. Every
operator is assembled at DEIM entries only (see ``fom/base.py``).
"""

import torch

from ..conventions import BDF, PistonParameters
from .base import OneDimensionalSolver


class OneDimensionalBurgers(OneDimensionalSolver):
    """Moving-piston gas dynamics operators at DEIM entries."""

    ALPHA = 1e-10   # artificial viscosity
    GAMMA = 1.4     # heat capacity ratio
    BDF_SCHEME = BDF.TWO

    def nonlinear_coefficient(self, mu):
        """b0 = (γ+1)/2 · a0."""
        return (self.GAMMA + 1.0) / 2.0 * mu[PistonParameters.A0]

    def create_diffusion_coefficient(self, mu=None):
        return self.ALPHA

    def compute_mesh_velocity(self, mu, t):
        """w(x) = x·L̇t/Lt."""
        dLt_dt = self.dLt_dt(t=t, **mu)
        Lt = self.Lt(t=t, **mu)
        return lambda x: x * dLt_dt / Lt

    def create_lifting_operator(self, mu, t, L, only_g=False):
        """One-sided lifting g = bL·x/L."""
        bL = self._dirichlet_value(self.BL, mu, t, L)

        def g(x):
            return bL * (x / L)

        if only_g:
            return g
        dbL = self._dirichlet_value(self.DBL_DT, mu, t, L)

        def dg_dt(x):
            return dbL * (x / L)

        return g, dg_dt, bL / L

    # ------------------------------------------------------------------
    # LHS operators
    # ------------------------------------------------------------------
    def assemble_stiffness(self, mu, t, entries=None):
        """α ∇u·∇v."""
        alpha = self.create_diffusion_coefficient(mu)
        coeff = lambda x, elements: alpha * torch.ones_like(x)
        return self._assemble_matrix([(1, 1, coeff)], mu, t, entries)

    def assemble_convection(self, mu, t, entries=None):
        """−(a0 + w)·u′·v."""
        a0 = mu[PistonParameters.A0]
        w = self.compute_mesh_velocity(mu=mu, t=t)
        coeff = lambda x, elements: -(a0 + w(x))
        return self._assemble_matrix([(1, 0, coeff)], mu, t, entries)

    def assemble_trilinear(self, mu, t, entries=None, u_n=None):
        """b0·uₙ·u′·v for a dof-vector state ``u_n`` (nh, ...)."""
        b0 = self.nonlinear_coefficient(mu)
        p = self.mesh.degree
        u_n = torch.as_tensor(u_n)

        def coeff(x, elements):
            idx = (p * torch.as_tensor(elements)[:, None]
                   + torch.arange(p + 1)[None, :])
            B0 = torch.as_tensor(self.mesh.tables.B0, dtype=x.dtype,
                                 device=x.device)
            u_eq = torch.einsum("ei...,qi->eq...",
                                u_n.to(x)[idx.to(x.device)], B0)
            u_eq = u_eq.reshape(u_eq.shape + (1,) * (x.ndim - u_eq.ndim))
            return b0 * u_eq

        return self._assemble_matrix([(1, 0, coeff)], mu, t, entries)

    def assemble_nonlinear_lifting(self, mu, t, entries=None):
        """b0·(g·u′ + g′·u)·v."""
        L = self.domain[self.L0] * self.scale_factor(mu, t)
        g, _, grad_g = self.create_lifting_operator(mu=mu, t=t, L=L)
        b0 = self.nonlinear_coefficient(mu)
        terms = [
            (1, 0, lambda x, elements: b0 * g(x)),
            (0, 0, lambda x, elements: b0 * grad_g * torch.ones_like(x)),
        ]
        return self._assemble_matrix(terms, mu, t, entries)

    # ------------------------------------------------------------------
    # RHS operators
    # ------------------------------------------------------------------
    def assemble_lifting(self, mu, t, entries=None):
        """−(ġ + b0·g·g′)·v + (a0+w)·g′·v − α·g′·v′."""
        L = self.domain[self.L0] * self.scale_factor(mu, t)
        g, dg_dt, grad_g = self.create_lifting_operator(mu=mu, t=t, L=L)
        b0 = self.nonlinear_coefficient(mu)
        a0 = mu[PistonParameters.A0]
        w = self.compute_mesh_velocity(mu=mu, t=t)
        alpha = self.create_diffusion_coefficient(mu)
        terms = [
            (0, lambda x, elements: (-(dg_dt(x) + b0 * g(x) * grad_g)
                                     + (a0 + w(x)) * grad_g)),
            (1, lambda x, elements: -alpha * grad_g * torch.ones_like(x)),
        ]
        return self._assemble_vector(terms, mu, t, entries)

    def assemble_rhs(self, mu, t, entries=None):
        """RHS = lifting only (no forcing for the piston)."""
        return self.assemble_lifting(mu=mu, t=t, entries=entries)
