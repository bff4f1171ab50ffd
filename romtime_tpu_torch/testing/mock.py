"""Minimal concrete FOMs for the (M)DEIM tests (counterpart of
``romtime_tpu/testing/mock.py``): stiffness, mass, convection and forcing
assembly against the real assembly without a time loop; the moving
variant integrates on the scaled domain."""

import torch

from ..fom.base import OneDimensionalSolver, move_mesh


class MockSolver(OneDimensionalSolver):
    def __init__(self, domain, dirichlet, forcing_term=None, Lt=None,
                 degrees=1, device="cuda") -> None:
        super().__init__(domain=domain, dirichlet=dirichlet, poly_type="P",
                         degrees=degrees, forcing_term=forcing_term, Lt=Lt,
                         device=device)

    def assemble_system(self, mu, t, bdf=1.0, u_n=None, u_n1=None):
        pass

    def assemble_system_rhs(self, mu, t, Mh_mat, u_n, u_n1=None):
        pass

    def create_diffusion_coefficient(self, mu, t):
        """Time-dependent diffusion α₀(1 + t²)."""
        return mu["alpha_0"] * (1.0 + t * t)

    def assemble_stiffness(self, mu, t, entries=None):
        alpha = self.create_diffusion_coefficient(mu=mu, t=t)
        coeff = lambda x: alpha * torch.ones_like(x)
        return self._assemble_matrix([(1, 1, coeff)], mu, t, entries)

    def assemble_convection(self, mu, t, entries=None):
        """−u′·v."""
        coeff = lambda x: -torch.ones_like(x)
        return self._assemble_matrix([(1, 0, coeff)], mu, t, entries)

    def assemble_forcing(self, mu, t, entries=None):
        coeff = lambda x: self._eval_field(self.forcing_term, x, mu, t)
        return self._assemble_vector([(0, coeff)], mu, t, entries)

    def assemble_lifting(self, mu, t, entries=None):
        pass


class MockSolverMoving(MockSolver):
    """Moving variant: every form on the scaled domain."""

    MOVING_ASSEMBLY = True

    @move_mesh
    def assemble_stiffness(self, mu, t, entries=None):
        return super().assemble_stiffness(mu, t, entries=entries)
