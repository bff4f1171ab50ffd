"""The multi-device dry run (counterpart of ``__graft_entry__.py``'s
``dryrun_multichip``, ``_dryrun_impl`` and ``_dryrun_serving``): the
offline step over a :class:`~romtime_tpu_torch.parallel.mesh.DeviceMesh`
on tiny shapes, then the routed μ-local serving sharded over it.

    python -c "from romtime_tpu_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip()"

runs it on every card of the machine. It runs where the mesh says and
never moves itself onto another device: a mesh of CPU entries
(``DeviceMesh([torch.device("cpu")] * 8)``) is the caller's choice.
"""

import contextlib
import os
import tempfile

import numpy as np
import torch

from ..conventions import Stage
from ..dtypes import compute_dtype, compute_dtype_scope, full_f32_matmul
from ..ops.assembly import band_matvec
from .mesh import device_mesh, replicated
from .sweep import (
    _run_sharded,
    solve_fom_sharded,
    solve_online_windowed_sharded,
)
from .tsqr import tsqr_svd

#: Modes of the dry run's reduced basis.
N_MODES = 3
#: ``build_mulocal_serving``'s arguments of the serving step's fleet
#: (its sampler is ``RandomState(3)``).
FLEET = dict(n_cells=2, n_windows=4, num_basis=12, snapshots_per_cell=2,
             dump=False, snapshot_cache=False)


def tiny_piston(nx=32, nt=4, device="cuda"):
    """The piston FOM of the dry run (L=1, tf=0.1, regime "rest"), set
    up, on ``device``."""
    from ..fom.nonlinear import OneDimensionalBurgers
    from ..problems import define_piston_problem

    domain, bcs, forcing, u0, Lt, dLt_dt = define_piston_problem(
        L=1.0, nx=nx, tf=0.1, nt=nt)
    solver = OneDimensionalBurgers(
        domain=domain, dirichlet=bcs,
        parameters=dict(a0=10.0, omega=18.0, alpha=1e-6, delta=0.12,
                        gamma=1.4),
        forcing_term=forcing, u0=u0, Lt=Lt, dLt_dt=dLt_dt, device=device)
    solver.setup()
    return solver


def entry(device="cuda"):
    """(forward, (mu,)): the scanned BDF-2 forward solve of the piston
    model (counterpart of ``__graft_entry__.py`` ``entry``): ``forward``
    maps μ, a dict of 0-d float64 tensors on ``device``, to the
    homogeneous trajectory ``uh`` (nt, nh) of :func:`tiny_piston` at
    nx=64, nt=8 on ``device`` (the card unless asked for the CPU)."""
    from ..utils.cli import resolve_device

    device = resolve_device(device)
    solver = tiny_piston(nx=64, nt=8, device=str(device))
    mu = {k: torch.tensor(float(v), dtype=torch.float64, device=device)
          for k, v in solver.mu.items()}

    def forward(mu):
        dtype = next(iter(mu.values())).dtype
        with compute_dtype_scope(dtype), full_f32_matmul(), torch.no_grad():
            return solver._solve_impl(mu)["uh"]

    return forward, (mu,)


def dryrun_batch(n):
    """The seeded μ batch of the offline step, ``n`` μ (the reference's
    ``__graft_entry__.py:144-151``), name → numpy (n,)."""
    rng = np.random.default_rng(0)
    return {"a0": rng.uniform(8.0, 10.0, n),
            "omega": rng.uniform(15.0, 20.0, n),
            "delta": rng.uniform(0.1, 0.15, n),
            "alpha": np.full(n, 1e-6),
            "gamma": np.full(n, 1.4)}


def serving_mus(n):
    """The seeded μ list of the serving step, ``n`` μ spanning the box
    (the reference's ``__graft_entry__.py`` ``_dryrun_serving``)."""
    rng = np.random.default_rng(1)
    return [dict(a0=float(a), omega=float(w), delta=float(d), alpha=1e-6,
                 gamma=1.4)
            for a, w, d in zip(rng.uniform(8, 10, n), rng.uniform(15, 20, n),
                               rng.uniform(0.1, 0.15, n))]


def training_step(solver, batch, mesh):
    """The offline step over ``mesh`` in the compute dtype: the FOM sweep
    sharded over the μ batch, TSQR over the (μ·t) snapshot axis (one
    shard's rows are its μ's trajectories), the first :data:`N_MODES`
    modes as the basis, replicated on every device, and per shard the
    Galerkin projection and one reduced solve K_N u_N = b_N at t = dt from
    the zero state. Returns the scalar Σu_N² + ΣV[0]²; raises where it is
    not finite."""
    snaps = solve_fom_sharded(solver, batch, mesh=mesh)["uh"]
    nh = snaps.shape[-1]
    U, _s = tsqr_svd(snaps.reshape(-1, nh).T, mesh=mesh)
    V = U[:, :N_MODES]
    V_on = dict(zip(mesh.devices, replicated(
        mesh, torch.as_tensor(V, dtype=compute_dtype()))))
    p = solver.mesh.degree

    def project(band, Vd):
        AV = band_matvec(band[:, :, None, :], Vd[:, :, None], p)
        return torch.einsum("ni,njB->ijB", Vd, AV)

    def reduced_step(mu):
        ref = next(iter(mu.values()))
        Vd = V_on[ref.device]
        zeros = ref.new_zeros((nh, ref.shape[0]))
        t = torch.full((), float(solver.dt), dtype=ref.dtype,
                       device=ref.device)
        Mh, Kh = solver.assemble_system(mu, t, 1.0, zeros, zeros)
        bh = solver.assemble_system_rhs(mu, t, Mh, zeros, zeros)
        KN = project(Kh.band, Vd)
        uN = torch.linalg.solve(KN.permute(2, 0, 1), (Vd.T @ bh).T)
        return {"uN": (uN, 0)}

    with torch.no_grad():
        uN = _run_sharded(batch, mesh, reduced_step)["uN"]
    value = float(np.sum(uN.astype(np.float64) ** 2)
                  + np.sum(V[0].astype(np.float64) ** 2))
    if not np.isfinite(value):
        raise FloatingPointError(f"dry run diagnostic not finite: {value}")
    return value


def serving_hrom(device="cuda", workdir=None):
    """A tiny piston HROM with a μ-local fleet attached, built by the
    port (the reference's ``_dryrun_serving`` build: nx=150, nt=96, 3
    offline μ, N-MDEIM of 10 modes, two Mach cells of 4 equal windows at
    N=12 from 2 training μ each), in ``workdir`` (default a temporary
    directory, removed after; the build writes its pickles there)."""
    from ..problems import piston_profile
    from ..rom.hrom import HyperReducedPiston

    cwd = os.getcwd()
    with contextlib.ExitStack() as stack:
        if workdir is None:
            workdir = stack.enter_context(tempfile.TemporaryDirectory())
        os.chdir(workdir)
        stack.callback(os.chdir, cwd)
        hrom = HyperReducedPiston(**piston_profile(
            nx=150, nt=96, tf=0.6, n_offline=3, modes=None, truncate=2,
            nmdeim=10, tri_mu=2, walk_stride=1, device=device))
        hrom.setup()
        hrom.setup_hyperreduction()
        hrom.run_offline_rom()
        hrom.run_offline_hyperreduction(
            mu_space=hrom.mu_space[Stage.OFFLINE], evaluate=False)
        hrom.project_reductors()
        hrom.build_mulocal_serving(rnd=np.random.RandomState(3), **FLEET)
    return hrom


def serving_step(rom, mus, mesh):
    """The routed μ-local serving of ``mus`` in float64, each cell's
    sub-batch through the windowed sweep sharded over ``mesh``. Returns
    the scalar Σ probes²; raises on a wrong shape or a value that is not
    finite."""
    with compute_dtype_scope(torch.float64):
        outs = rom.solve_batch_mulocal(
            mus, step=Stage.ONLINE, mode="probes",
            sweep_fn=lambda sub: solve_online_windowed_sharded(
                rom, sub, mesh=mesh, mode="probes"))
    probes = np.asarray(outs["probes"], np.float64)
    if probes.shape[0] != len(mus) or not np.isfinite(probes).all():
        raise FloatingPointError(
            f"sharded serving gave {probes.shape} probes, finite "
            f"{bool(np.isfinite(probes).all())}")
    return float(np.sum(probes ** 2))


def dryrun_multichip(mesh=None, rom=None):
    """The dry run over ``mesh`` (default :func:`device_mesh`, every
    card): :func:`training_step` on :func:`tiny_piston` (nx=32, nt=4)
    with one μ a shard, then :func:`serving_step` on ``rom`` (default
    :func:`serving_hrom`'s ROM, built on the mesh's first device) with
    one μ a shard. Returns (offline diagnostic, serving diagnostic)."""
    if mesh is None:
        mesh = device_mesh()
    n = mesh.size
    home = str(mesh.devices[0])
    value = training_step(tiny_piston(device=home), dryrun_batch(n), mesh)
    print(f"dryrun_multichip({mesh}) OK: diagnostic={value:.6e}")
    if rom is None:
        rom = serving_hrom(home).rom
    served = serving_step(rom, serving_mus(n), mesh)
    print(f"dryrun_multichip({mesh}) serving OK: cells routed, sharded "
          f"windowed sweep diagnostic={served:.6e}")
    return value, served
