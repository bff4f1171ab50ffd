"""Oscillating-piston problem definition (counterpart of
``romtime_tpu/problems/piston.py``): right-boundary piston velocity, free
outflow on the left, homogeneous start. Callables take torch tensors
(scalars or batched μ lanes) and broadcast."""

import torch

from ..fom.nonlinear import OneDimensionalBurgers


def define_piston_problem(L=None, nx=None, tf=None, nt=None, which="rest"):
    """Returns (domain, boundary_conditions, forcing_term, u0, Lt, dLt_dt)."""
    domain = {
        OneDimensionalBurgers.L0: L,
        OneDimensionalBurgers.T: tf,
        OneDimensionalBurgers.NX: nx,
        OneDimensionalBurgers.NT: nt,
    }

    if which == "sudden":

        def bL(t, L=None, dLt_dt=0.0, delta=None, omega=None, a0=None, **mu):
            return -delta * (omega / a0) * torch.cos(omega * t)

        def dbL_dt(t, L=None, dLt_dt=0.0, delta=None, omega=None, a0=None,
                   **mu):
            return delta * omega * (omega / a0) * torch.sin(omega * t)

        def Lt(omega, delta, t, **kwargs):
            return 1.0 - delta * torch.sin(omega * t)

        def dLt_dt(omega, delta, t, **kwargs):
            return -omega * delta * torch.cos(omega * t)

    elif which == "rest":

        def bL(t, L=None, dLt_dt=0.0, delta=None, omega=None, a0=None, **mu):
            return -delta * (omega / a0) * torch.sin(omega * t)

        def dbL_dt(t, L=None, dLt_dt=0.0, delta=None, omega=None, a0=None,
                   **mu):
            return -delta * omega * (omega / a0) * torch.cos(omega * t)

        def Lt(omega, delta, t, **kwargs):
            return 1.0 - delta * (1.0 - torch.cos(omega * t))

        def dLt_dt(omega, delta, t, **kwargs):
            return -omega * delta * torch.sin(omega * t)

    else:
        raise NotImplementedError("Which case do you want to solve?")

    boundary_conditions = {"bL": bL, "dbL_dt": dbL_dt}

    def u0(x, t=0.0, **mu):
        return torch.zeros_like(x)

    return domain, boundary_conditions, None, u0, Lt, dLt_dt
