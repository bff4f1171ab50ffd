"""Heat equation solvers on fixed and moving 1-D domains (counterpart of
``romtime_tpu/fom/heat.py``), with the unified BDF contract
``assemble_system(mu, t, bdf, u_n, u_n1)``.

Physics: u_t − α u_xx = f with the Dirichlet data carried by a linear
lifting g; the moving variant adds the ALE mesh-velocity convection
−w u′ v and integrates every form on the scaled domain. The plain and dd
loops, degrees 1-5 and the banded solves are the base solver's
(``fom/base.py``).
"""

import torch

from ..conventions import BDF
from .base import BandedOperator, OneDimensionalSolver, move_mesh


class HeatEquationSolver(OneDimensionalSolver):
    """Implicit heat solver on the fixed domain (reference
    ``fom/heat.py:19-123``): BDF-1 by default, the scheme behind the
    golden error anchors; BDF-2 through ``bdf_scheme``."""

    BDF_SCHEME = BDF.ONE
    MOVING_ASSEMBLY = False

    def __init__(self, domain: dict, dirichlet: dict, parameters: dict = None,
                 forcing_term=None, u0=None, filename=None, poly_type="P",
                 degrees=1, project_u0=False, exact_solution=None, Lt=None,
                 dLt_dt=None, bdf_scheme=None, device="cuda") -> None:
        super().__init__(
            domain=domain, dirichlet=dirichlet, parameters=parameters,
            forcing_term=forcing_term, u0=u0, Lt=Lt, dLt_dt=dLt_dt,
            filename=filename, poly_type=poly_type, degrees=degrees,
            project_u0=project_u0, exact_solution=exact_solution,
            bdf_scheme=bdf_scheme, device=device)
        self.alpha = None

    def create_diffusion_coefficient(self, mu=None):
        """Constant diffusion α = α₀."""
        return mu["alpha_0"]

    # ------------------------------------------------------------------
    # Unified BDF system
    # ------------------------------------------------------------------
    def assemble_system(self, mu, t, bdf=1.0, u_n=None, u_n1=None):
        """(M, K = bdf·M + dt·A)."""
        Mh = self.assemble_mass(mu=mu, t=t)
        Ah = self.assemble_stiffness(mu=mu, t=t)
        return Mh, BandedOperator(bdf * Mh.band + self.dt * Ah.band,
                                  self.mesh)

    def assemble_system_rhs(self, mu, t, Mh_mat, u_n, u_n1=None):
        """b = M·uₙ + dt·f (BDF-1), or M·(2uₙ − ½uₙ₋₁) + dt·f."""
        fh = self.assemble_rhs(mu=mu, t=t)
        if u_n1 is None:
            bdf_term = Mh_mat.dot(u_n)
        else:
            bdf_term = Mh_mat.dot(2.0 * u_n - 0.5 * u_n1)
        return bdf_term + self.dt * fh

    # ------------------------------------------------------------------
    # Operators
    # ------------------------------------------------------------------
    def assemble_stiffness(self, mu, t, entries=None):
        """α ∇u·∇v."""
        alpha = self.create_diffusion_coefficient(mu)
        coeff = lambda x: alpha * torch.ones_like(x)
        return self._assemble_matrix([(1, 1, coeff)], mu, t, entries)

    def assemble_forcing(self, mu, t, entries=None):
        """f(x, t, μ)·v."""
        coeff = lambda x: self._eval_field(self.forcing_term, x, mu, t)
        return self._assemble_vector([(0, coeff)], mu, t, entries)

    def assemble_lifting(self, mu, t, entries=None):
        """−(ġ v + α ∇g·∇v)."""
        scale = self._assembly_scale(mu, t)
        L = self.domain[self.L0] * scale
        _, dg_dt, grad_g = self.create_lifting_operator(mu=mu, t=t, L=L)
        alpha = self.create_diffusion_coefficient(mu)
        terms = [
            (0, lambda x: -dg_dt(x)),
            (1, lambda x: -alpha * grad_g * torch.ones_like(x)),
        ]
        return self._assemble_vector(terms, mu, t, entries)

    def assemble_rhs(self, mu, t, entries=None):
        """Forcing + lifting."""
        fh = self.assemble_forcing(mu=mu, t=t, entries=entries)
        fgh = self.assemble_lifting(mu=mu, t=t, entries=entries)
        return fh + fgh


class HeatEquationMovingSolver(HeatEquationSolver):
    """ALE heat solver on the uniformly scaled domain (reference
    ``fom/heat.py:126-149``): every form integrates over the scaled mesh
    (``MOVING_ASSEMBLY``; the decorators are parity markers), and the
    system carries the mesh-velocity convection."""

    MOVING_ASSEMBLY = True

    def compute_mesh_velocity(self, mu, t):
        """w(x) = x·L̇t/Lt on the scaled domain."""
        dLt_dt = self._per_step("dLt_dt", lambda: self.dLt_dt(t=t, **mu))
        Lt = self.scale_factor(mu, t)
        return lambda x: x * dLt_dt / Lt

    def assemble_system(self, mu, t, bdf=1.0, u_n=None, u_n1=None):
        """(M, K = bdf·M + dt·(C + A))."""
        Mh = self.assemble_mass(mu=mu, t=t)
        Ah = self.assemble_stiffness(mu=mu, t=t)
        Ch = self.assemble_convection(mu=mu, t=t)
        return Mh, BandedOperator(
            bdf * Mh.band + self.dt * (Ch.band + Ah.band), self.mesh)

    @move_mesh
    def assemble_convection(self, mu, t, entries=None):
        """−w u′ v."""
        w = self.compute_mesh_velocity(mu=mu, t=t)
        coeff = lambda x: -w(x)
        return self._assemble_matrix([(1, 0, coeff)], mu, t, entries)
