"""MFP1, the manufactured heat problem on fixed and moving domains
(counterpart of ``romtime_tpu/problems/mfp1.py``).

Exact solution u_e = (1 − e^{−βt})(1 + δ²x²); the Dirichlet data and the
forcing follow from it. Callables take torch tensors (scalars or batched
μ lanes) and broadcast.
"""

import torch

from ..fom.heat import HeatEquationSolver


def define_mfp1_problem(L=None, nx=None, tf=None, nt=None):
    """The MFP1 problem definition: (domain, boundary_conditions,
    forcing_term, u0, ue, Lt, dLt_dt)."""
    domain = {
        HeatEquationSolver.L0: L,
        HeatEquationSolver.T: tf,
        HeatEquationSolver.NX: nx,
        HeatEquationSolver.NT: nt,
    }

    def b0(t, L=None, dLt_dt=0.0, beta=None, **mu):
        return 1.0 - torch.exp(-beta * t)

    def bL(t, L=None, dLt_dt=0.0, beta=None, delta=None, **mu):
        return (1.0 - torch.exp(-beta * t)) * (1.0 + delta * delta * L * L)

    def db0_dt(t, L=None, dLt_dt=0.0, beta=None, **mu):
        return beta * torch.exp(-beta * t)

    def dbL_dt(t, L=None, dLt_dt=0.0, beta=None, delta=None, **mu):
        decay = torch.exp(-beta * t)
        linear = beta * decay * (1.0 + delta * delta * L * L)
        moving = 2.0 * (1.0 - decay) * (delta * delta) * L * dLt_dt
        return linear + moving

    boundary_conditions = {"b0": b0, "bL": bL, "db0_dt": db0_dt,
                           "dbL_dt": dbL_dt}

    def forcing_term(x, t, beta=None, delta=None, alpha_0=None, **mu):
        decay = torch.exp(-beta * t)
        return beta * decay * (1.0 + delta * delta * x * x) - (
            2.0 * delta * delta * alpha_0 * (1.0 - decay))

    def u0(x, t=0.0, **mu):
        return torch.zeros_like(x)

    def ue(x, t, beta=None, delta=None, **mu):
        return (1.0 - torch.exp(-beta * t)) * (1.0 + delta * delta * x * x)

    def Lt(omega, t, **kwargs):
        """Mesh scaling."""
        return 1.0 - torch.sin(omega * t)

    def dLt_dt(omega, t, **kwargs):
        """Its time derivative."""
        return -omega * torch.cos(omega * t)

    return domain, boundary_conditions, forcing_term, u0, ue, Lt, dLt_dt


def __getattr__(name):
    # The reference keeps an older generation of the heat drivers in this
    # module; the old import path resolves to their counterparts
    # (mfp1_legacy.py).
    if name in ("HyperReducedOrderModelFixed", "HyperReducedOrderModelMoving"):
        from . import mfp1_legacy

        return getattr(mfp1_legacy, name)
    raise AttributeError(
        f"module 'romtime_tpu_torch.problems.mfp1' has no attribute {name!r}")
