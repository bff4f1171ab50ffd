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


def piston_profile(nx=1000, nt=1500, tf=1.0, n_offline=3, modes=20,
                   truncate=5, nmdeim=12, tri_mu=2, walk_stride=None,
                   seed=0, device="cuda"):
    """The keyword arguments of ``rom.hrom.HyperReducedPiston`` for a
    piston build on the reference's μ box (``bench.py:117-190``): P1,
    BDF-2, a0 ∈ [8, 10], ω ∈ [15, 20], δ ∈ [0.1, 0.15] (α = 1e-6,
    γ = 1.4), ``n_offline`` offline μ from the Mach-stratified sampler
    with ``RandomState(seed)``, an S-ROM of ``modes`` modes (None: the
    POD's own truncation) truncated by ``truncate`` into the ROM, the
    N-MDEIM kept to ``nmdeim`` modes, the tree walk on every
    ``walk_stride``-th step (default nt // 100), the N-MDEIM's on every
    fourth of those with ``tri_mu`` μ, all six operator models; built on
    ``device``."""
    import numpy as np

    from ..conventions import OperatorType, PistonParameters, RomParameters
    from ..parameters import get_uniform_dist

    domain, bcs, forcing, u0, Lt, dLt_dt = define_piston_problem(
        L=1.0, nx=nx, tf=tf, nt=nt)
    grid = {
        PistonParameters.A0: get_uniform_dist(min=8.0, max=10.0),
        PistonParameters.OMEGA: get_uniform_dist(min=15.0, max=20.0),
        PistonParameters.DELTA: get_uniform_dist(min=0.1, max=0.15),
        PistonParameters.ALPHA: get_uniform_dist(min=1e-6, max=1e-6),
        PistonParameters.GAMMA: get_uniform_dist(min=1.4, max=1.4),
    }
    ts = np.linspace(tf / nt, tf, nt)
    ts_walk = ts[:: walk_stride or max(1, nt // 100)]
    walk = {RomParameters.TS: ts_walk, RomParameters.NUM_SNAPSHOTS: n_offline}
    return dict(
        grid=grid,
        fom_params=dict(domain=domain, dirichlet=bcs, forcing_term=forcing,
                        u0=u0, Lt=Lt, dLt_dt=dLt_dt,
                        grid_params={k: "uniform" for k in grid}),
        rom_params={RomParameters.NUM_SNAPSHOTS: n_offline,
                    RomParameters.NUM_MU: modes,
                    RomParameters.SROM_TRUNCATE: truncate,
                    RomParameters.TOL_TIME: None, RomParameters.TOL_MU: None,
                    RomParameters.NMDEIM_SIZE: nmdeim},
        deim_params=dict(walk), mdeim_params=dict(walk),
        mdeim_nonlinear_params={RomParameters.TS: ts_walk[::4],
                                RomParameters.NUM_SNAPSHOTS: tri_mu},
        models={k: True for k in (
            OperatorType.MASS, OperatorType.STIFFNESS, OperatorType.RHS,
            OperatorType.CONVECTION, OperatorType.NONLINEAR_LIFTING,
            OperatorType.TRILINEAR)},
        rnd=np.random.RandomState(seed), device=device)


def throughput_profile(nx=1000, nt=1500, tf=1.0, n_offline=3, modes=20,
                       truncate=5, nmdeim=12, tri_mu=2, seed=0,
                       device="cuda"):
    """``bench.py``'s throughput profile (``bench.py:117-190``): 3
    offline μ, an S-ROM of 20 modes truncated by 5, the N-MDEIM kept to
    12 modes from 2 μ (:func:`piston_profile`)."""
    return piston_profile(nx=nx, nt=nt, tf=tf, n_offline=n_offline,
                          modes=modes, truncate=truncate, nmdeim=nmdeim,
                          tri_mu=tri_mu, seed=seed, device=device)


def joint_profile(nx=1000, nt=1500, tf=1.0, n_offline=8, modes=96,
                  truncate=8, nmdeim=96, tri_mu=3, seed=0, device="cuda"):
    """The global build of ``bench.py``'s flagship "joint" profile
    (``bench.py:64-115``, ``:117-190``): 8 offline μ, an S-ROM of 96
    modes truncated by 8, the N-MDEIM kept to 96 modes from 3 μ on every
    fourth tree-walk time (:func:`piston_profile`). Its fleet is
    :func:`joint_fleet`."""
    return piston_profile(nx=nx, nt=nt, tf=tf, n_offline=n_offline,
                          modes=modes, truncate=truncate, nmdeim=nmdeim,
                          tri_mu=tri_mu, seed=seed, device=device)


#: ``bench.py``'s held-out certification μ, the box center (bench.py:343).
JOINT_CENTER_MU = dict(a0=9.3, omega=17.5, delta=0.12, alpha=1e-6,
                       gamma=1.4)


def joint_fleet(per_cell=(12, 12, 12, 12, 16, 24), register="auto",
                cell_wn=((50, 32),) * 4 + ((150, 48),) * 2, srom_extra=8):
    """``HyperReducedPiston.build_mulocal_serving``'s keyword arguments
    for the flagship fleet (``bench.py:111-115``, ``:343-400``): six
    equal-width Mach cells, ``per_cell`` training μ a cell, four 50x32
    and two 150x48 cells, every alignable cell registered, each built at
    N + ``srom_extra`` for its nested S-ROM."""
    return dict(n_cells=len(cell_wn), n_windows=int(cell_wn[0][0]),
                num_basis=int(cell_wn[0][1]),
                snapshots_per_cell=[int(n) for n in per_cell],
                cell_wn=[tuple(int(v) for v in wn) for wn in cell_wn],
                register=register, srom_extra=srom_extra)
