"""Oscillating-piston ROM walkthrough (counterpart of
``examples/piston_rom.py``): the flagship pipeline end to end on a small
configuration.

Stages:
  1. offline  — FOM sweeps per μ, hierarchical POD, (M)DEIM + N-MDEIM
                training, Galerkin projection (float64 whatever the
                ambient dtype, as every offline step of the port);
  2. online   — a lane-batched μ-sweep in serving mode (probe QoIs only),
                in the port's float32 serving dtype: on the card a batch
                of whole 128-lane blocks serves through K4 or K5, any
                other batch through the global lanes engine (the
                reference's gate, ``rom/engines/global_fused.supported``);
  3. certify  — batched S-ROM error estimation in float64, no FOM in the
                loop.

    python -m romtime_tpu_torch.examples.piston_rom [--windowed]
        [--device cpu] [--workdir DIR]

``--windowed`` runs the flagship serving configuration instead: time
windows, two μ-local Mach cells, per-cell S-ROM certification. The
artifacts (probe CSVs, pickles) go to ``--workdir`` (default a new
temporary directory).
"""

import argparse
import contextlib
import os
import tempfile
import time

import numpy as np
import torch

from ..conventions import (
    Errors,
    OperatorType,
    PistonParameters,
    RomParameters,
    Stage,
)
from ..dtypes import compute_dtype_scope
from ..parameters import get_uniform_dist
from ..problems import define_piston_problem
from ..utils.cli import add_device_argument, resolve_device

#: The windowed configuration of ``--windowed`` (the JAX example's).
WINDOWED = dict(n_windows=6, num_basis=16, srom_extra=4)
FLEET = dict(n_cells=2, n_windows=6, num_basis=16, snapshots_per_cell=4,
             srom_extra=4)


def pipeline_arguments(nx=300, nt=300, device="cuda"):
    """``HyperReducedPiston``'s keyword arguments of the small piston HROM
    (the JAX example's ``build_pipeline``, :40-90), on ``device``."""
    tf = 1.0
    domain, bcs, forcing, u0, Lt, dLt_dt = define_piston_problem(
        L=1.0, nx=nx, tf=tf, nt=nt)
    grid = {
        PistonParameters.A0: get_uniform_dist(min=8.0, max=10.0),
        PistonParameters.OMEGA: get_uniform_dist(min=15.0, max=20.0),
        PistonParameters.DELTA: get_uniform_dist(min=0.1, max=0.15),
        PistonParameters.ALPHA: get_uniform_dist(min=1e-6, max=1e-6),
        PistonParameters.GAMMA: get_uniform_dist(min=1.4, max=1.4),
    }
    fom_params = dict(
        domain=domain, dirichlet=bcs, forcing_term=forcing, u0=u0,
        Lt=Lt, dLt_dt=dLt_dt, grid_params={k: "uniform" for k in grid},
    )
    ts = np.linspace(tf / nt, tf, nt)[:: max(1, nt // 60)]
    return dict(
        grid=grid,
        fom_params=fom_params,
        rom_params={
            RomParameters.NUM_SNAPSHOTS: 3,
            RomParameters.NUM_MU: 12,
            RomParameters.SROM_TRUNCATE: 4,
            RomParameters.TOL_TIME: None,
            RomParameters.TOL_MU: None,
            RomParameters.NMDEIM_SIZE: 10,
        },
        deim_params={RomParameters.TS: ts, RomParameters.NUM_SNAPSHOTS: 3},
        mdeim_params={RomParameters.TS: ts, RomParameters.NUM_SNAPSHOTS: 3},
        mdeim_nonlinear_params={RomParameters.TS: ts[::4],
                                RomParameters.NUM_SNAPSHOTS: 2},
        models={
            OperatorType.MASS: True,
            OperatorType.STIFFNESS: True,
            OperatorType.RHS: True,
            OperatorType.CONVECTION: True,
            OperatorType.NONLINEAR_LIFTING: True,
            OperatorType.TRILINEAR: True,
        },
        rnd=np.random.RandomState(0),
        device=str(resolve_device(device)),
    )


@contextlib.contextmanager
def working_directory(path):
    """``path`` as the working directory inside the scope (the build's
    dumps land there), the previous one restored after."""
    cwd = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(cwd)


def build_pipeline(workdir, nx=300, nt=300, device="cuda", evaluate=True):
    """The offline stages of the small piston HROM in ``workdir``: set-up,
    the FOM sweeps and POD, the (M)DEIM and N-MDEIM training (each
    reductor evaluated on the offline μ with ``evaluate``, as the JAX
    example's global walkthrough does), the projection. Returns (hrom,
    seconds)."""
    from ..rom.hrom import HyperReducedPiston

    with working_directory(workdir):
        t0 = time.perf_counter()
        hrom = HyperReducedPiston(**pipeline_arguments(nx, nt, device))
        hrom.setup()
        hrom.setup_hyperreduction()
        hrom.run_offline_rom()
        hrom.run_offline_hyperreduction(
            mu_space=hrom.mu_space[Stage.OFFLINE], evaluate=evaluate)
        hrom.project_reductors()
    return hrom, time.perf_counter() - t0


def serving_mus(rom, num=32):
    """``num`` Mach-stratified μ (``RandomState(5)``), the Mach key
    dropped."""
    mus = list(rom.build_sampling_space(num=num,
                                        rnd=np.random.RandomState(5)))
    for mu in mus:
        mu.pop(PistonParameters.MACH_PISTON, None)
    return mus


def serve(rom, mus):
    """``solve_batch(mus, mode="probes")`` twice (the first call builds
    the device tables): (the outputs, the second call's seconds)."""
    rom.solve_batch(mus, step=Stage.ONLINE, mode="probes")
    _sync(rom)
    t0 = time.perf_counter()
    served = rom.solve_batch(mus, step=Stage.ONLINE, mode="probes")
    _sync(rom)
    return served, time.perf_counter() - t0


def certify(hrom, mus, mulocal=False):
    """The batched S-ROM estimator in float64 (``estimate_batch``, or
    ``estimate_batch_mulocal`` on the fleet)."""
    with compute_dtype_scope(torch.float64):
        if mulocal:
            return hrom.estimate_batch_mulocal(mus, step=Stage.ONLINE)
        return hrom.estimate_batch(mus, step=Stage.ONLINE)


def _sync(rom):
    if rom.device.type == "cuda":
        torch.cuda.synchronize(rom.device)


def build_windowed_fleet(hrom):
    """The windowed serving and its nested S-ROM windows, then the two
    Mach cells (:data:`WINDOWED`, :data:`FLEET`), in the build's working
    directory. Returns (fleet, its build seconds)."""
    hrom.build_windowed_serving(**WINDOWED)
    t0 = time.perf_counter()
    ml = hrom.build_mulocal_serving(**FLEET)
    return ml, time.perf_counter() - t0


def serve_fleet(rom, mus):
    """The routed fleet through the windowed lanes engine, probes."""
    return rom.solve_batch_mulocal(mus, step=Stage.ONLINE, mode="probes",
                                   engine="windowed")


def main_global(workdir, device):
    print("offline: FOM sweep + POD + (M)DEIM training ...")
    hrom, seconds = build_pipeline(workdir, device=device)
    print(f"offline done in {seconds:.1f}s — ROM N={hrom.rom.N}, "
          f"S-ROM N={hrom.srom.N}")

    # Online serving sweep: probe QoIs only (nothing trajectory-sized
    # leaves the device).
    mus = serving_mus(hrom.rom)
    served, wall = serve(hrom.rom, mus)
    probes = served["probes"]  # (B, nt, 2): outflow + piston-face values
    print(f"online: {len(mus)} μ-solves in {wall:.2f}s "
          f"({len(mus) / wall:.0f} solves/s)")
    print(f"  piston-face velocity, μ₀, final step: {probes[0, -1, 1]:+.4f}")

    # Batched certification: S-ROM estimator per (μ, t), reduced-space only.
    avg = certify(hrom, mus)[Errors.AVERAGE_ESTIMATOR]
    print("certification (S-ROM estimator, time-averaged):")
    print(f"  median {np.median(avg):.2e}   worst {avg.max():.2e}")


def windowed_mulocal_serving(workdir, device):
    """The flagship serving configuration (smaller scale): time-windowed
    local bases, μ-local Mach cells and per-cell S-ROM certification."""
    hrom, _seconds = build_pipeline(workdir, device=device, evaluate=False)
    with working_directory(workdir):
        ml, seconds = build_windowed_fleet(hrom)
    print(f"mu-local build ({ml.n_cells} cells) in {seconds:.1f}s")

    mus = serving_mus(hrom.rom, num=16)
    served = serve_fleet(hrom.rom, mus)
    print(f"served {len(mus)} μ through routed windowed bases; "
          f"piston-face v, μ₀, final step: "
          f"{np.asarray(served['probes'])[0, -1, 1]:+.4f}")

    avg = np.asarray(certify(hrom, mus, mulocal=True)[
        Errors.AVERAGE_ESTIMATOR])
    print("per-cell S-ROM certification (time-averaged estimator):")
    print(f"  median {np.median(avg):.2e}   worst {avg.max():.2e}")


def main(argv=None):
    parser = add_device_argument(argparse.ArgumentParser(description=__doc__))
    parser.add_argument("--windowed", action="store_true")
    parser.add_argument("--workdir", default=None,
                        help="artifact directory (default: a new "
                             "temporary directory)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    workdir = args.workdir or tempfile.mkdtemp(prefix="piston_rom_")
    os.makedirs(workdir, exist_ok=True)
    if args.windowed:
        windowed_mulocal_serving(workdir, device)
    else:
        main_global(workdir, device)


if __name__ == "__main__":
    main()
