"""Windowed-serving operating-point study at the piston headline
configuration (counterpart of ``scripts/window_study.py``).

Sweeps (n_windows, num_basis) of the time-windowed local-basis serving
(``rom/windowed.py``) and reports, per point:

- projection floor: rel-L2 of the held-out FOM trajectory projected onto
  the per-window bases (the best any windowed ROM can do),
- served rel-L2: ``engine="windowed"`` (the windowed lanes engine,
  float64),
- f32 drift (``--f32``): the same engine under
  ``compute_dtype_scope(torch.float32)`` against the float64 solve.

    python -m romtime_tpu_torch.scripts.window_study [--nx 1000]
        [--nt 1500] [--snapshots 3] [--srom-modes 96] [--truncate 8]
        [--nmdeim 48] [--points 15:48 16:48 8:32] [--f32] [--floor-only]
        [--offline-f32] [--warm-dir DIR] [--device cpu]

``--floor-only`` computes the floors alone (``build_windowed_basis``, no
serving); ``--offline-f32`` runs the FOM sweep of the build as one
float32 ``solve_fom_batch`` on the device (POD and certification stay
float64); ``--warm-dir`` resumes a build directory instead of building
(its ``fom_validation_full.npz`` caches the held-out FOM solve). A fresh
build writes its dumps into a temporary directory, removed after. The
JAX script's jit-cache resets have no counterpart here.
"""

import argparse
import contextlib
import os
import tempfile
import time

import numpy as np
import torch

from ..conventions import Stage
from ..dtypes import compute_dtype_scope
from ..problems import JOINT_CENTER_MU
from ..utils.cli import add_device_argument, resolve_device

#: The held-out FOM cache in a warm directory (the JAX script's).
FOM_CACHE = "fom_validation_full.npz"


def parse_args(argv=None):
    ap = add_device_argument(argparse.ArgumentParser(description=__doc__))
    ap.add_argument("--nx", type=int, default=1000)
    ap.add_argument("--nt", type=int, default=1500)
    ap.add_argument("--snapshots", type=int, default=3)
    ap.add_argument("--srom-modes", type=int, default=96)
    ap.add_argument("--truncate", type=int, default=8)
    ap.add_argument("--nmdeim", type=int, default=48)
    ap.add_argument("--points", nargs="*", default=["15:48"],
                    help="list of W:N pairs")
    ap.add_argument("--f32", action="store_true",
                    help="also measure f32 drift per point")
    ap.add_argument("--floor-only", action="store_true",
                    help="projection floors only (no serving)")
    ap.add_argument("--offline-f32", action="store_true",
                    help="run the FOM sweep in float32 as one batched "
                         "device sweep; POD and certification stay f64")
    ap.add_argument("--warm-dir", default=None,
                    help="resume the offline pipeline from a build "
                         "directory (basis pickles + offline_snapshots.npz) "
                         "instead of rebuilding it")
    return ap.parse_args(argv)


def study_arguments(args):
    """``HyperReducedPiston``'s keyword arguments of the study's
    configuration (the JAX script's: the flags' grid, snapshot and mode
    counts, 2 μ for the N-MDEIM), on ``args.device``."""
    from ..problems import piston_profile

    return piston_profile(nx=args.nx, nt=args.nt, n_offline=args.snapshots,
                          modes=args.srom_modes, truncate=args.truncate,
                          nmdeim=args.nmdeim, tri_mu=2,
                          device=str(resolve_device(args.device)))


def build(args):
    """The HROM of the study, in the working directory: resumed from
    ``args.warm_dir``, or built (the FOM sweep as one float32 device
    sweep with ``args.offline_f32``)."""
    from ..rom.hrom import HyperReducedPiston

    t0 = time.perf_counter()
    hrom = HyperReducedPiston(**study_arguments(args))
    hrom.setup()
    hrom.setup_hyperreduction()
    if args.warm_dir:
        hrom.start_from_existing_basis()
    else:
        if args.offline_f32:
            with compute_dtype_scope(torch.float32):
                hrom.run_offline_rom(device_sweep=True)
        else:
            hrom.run_offline_rom()
        hrom.run_offline_hyperreduction(
            mu_space=hrom.mu_space[Stage.OFFLINE], evaluate=False)
    hrom.project_reductors()
    print(f"[study] offline pipeline: {time.perf_counter() - t0:.1f}s "
          f"(global N={hrom.rom.N})", flush=True)
    return hrom


def validation_fom(hrom, mu_val=JOINT_CENTER_MU, cache=None):
    """The held-out μ's float64 FOM trajectory and its homogeneous part,
    (nh, nt) each, read from ``cache`` (an npz of the same grid) or
    solved with ``fom.solve()`` and written there."""
    fom = hrom.fom
    nx, nt = int(fom.domain[fom.NX]), int(fom.domain[fom.NT])
    if cache and os.path.exists(cache):
        with np.load(cache) as d:
            if int(d["nx"]) == nx and int(d["nt"]) == nt:
                return d["uh"], d["uh_hom"]
    fom.setup()
    fom.update_parametrization(dict(mu_val))
    with compute_dtype_scope(torch.float64):
        fom.solve()
    uh_fom = np.asarray(fom.solutions.fom)        # (nh, nt), complete
    uh_hom = np.asarray(fom.solutions.snapshots)  # homogeneous part
    if cache:
        np.savez(cache, uh=uh_fom, uh_hom=uh_hom, nx=nx, nt=nt)
    return uh_fom, uh_hom


def window_floor(bounds, Vs, uh_hom, nrm):
    """rel-L2 of the homogeneous trajectory projected window by window
    onto ``Vs``, over ``nrm``: the best any windowed ROM can do."""
    err2 = 0.0
    for w in range(len(Vs)):
        a, b = int(bounds[w]), int(bounds[w + 1])
        seg = uh_hom[:, a:b]
        err2 += np.linalg.norm(seg - Vs[w] @ (Vs[w].T @ seg)) ** 2
    return float(np.sqrt(err2) / nrm)


def floor_point(snaps, W, N, uh_hom, nrm):
    """The projection floor at (W, N) from ``build_windowed_basis`` on the
    offline snapshots; raises ``ValueError`` where a window has too few
    snapshots."""
    from ..rom.windowed import build_windowed_basis

    bounds, Vs, _T = build_windowed_basis(snaps, n_windows=W, num_basis=N)
    return window_floor(bounds, Vs, uh_hom, nrm)


def served_point(hrom, W, N, uh_fom, uh_hom, f32=False,
                 mu_val=JOINT_CENTER_MU):
    """Serve the held-out μ on windows (W, N) built on the offline
    snapshots (attached to the ROM): {"floor", "rel", "build_s",
    "solve_s"} and with ``f32`` {"drift", "rel32"}. The float64 solve is
    the windowed lanes engine in ``mode="full"``."""
    rom = hrom.rom
    nrm = np.linalg.norm(uh_fom)
    t0 = time.perf_counter()
    win = rom.build_windowed_serving(n_windows=W, num_basis=N,
                                     snapshots=hrom.srom.offline_snapshots)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with compute_dtype_scope(torch.float64):
        outs = rom.solve_batch([dict(mu_val)], step=Stage.VALIDATION,
                               mode="full", engine="windowed")
    u = np.asarray(outs["uc"][0]).T  # (nh, nt)
    out = dict(floor=window_floor(win.bounds, np.asarray(win.Vs), uh_hom,
                                  nrm),
               rel=float(np.linalg.norm(u - uh_fom) / nrm), build_s=build_s,
               solve_s=time.perf_counter() - t0)
    if f32:
        with compute_dtype_scope(torch.float32):
            o32 = rom.solve_batch([dict(mu_val)], step=Stage.VALIDATION,
                                  mode="full", engine="windowed")
        u32 = np.asarray(o32["uc"][0], np.float64).T
        out.update(drift=float(np.linalg.norm(u32 - u) / nrm),
                   rel32=float(np.linalg.norm(u32 - uh_fom) / nrm))
    return out


def study(hrom, args, uh_fom, uh_hom):
    """Every point of ``args.points``: its floor alone
    (``args.floor_only``) or served (:func:`served_point`). Returns
    {"W:N": result or the reason it was skipped}."""
    nrm = np.linalg.norm(uh_fom)
    results = {}
    for spec in args.points:
        W, N = (int(x) for x in spec.split(":"))
        try:
            if args.floor_only:
                r = {"floor": floor_point(hrom.srom.offline_snapshots, W, N,
                                          uh_hom, nrm)}
                msg = f"floor(hom)={r['floor']:.2e}"
            else:
                r = served_point(hrom, W, N, uh_fom, uh_hom, args.f32)
                msg = (f"floor(hom)={r['floor']:.2e} served rel-L2="
                       f"{r['rel']:.2e} (build {r['build_s']:.1f}s, "
                       f"solve {r['solve_s']:.1f}s)")
                if args.f32:
                    msg += (f" f32-drift={r['drift']:.2e} f32 rel-L2="
                            f"{r['rel32']:.2e}")
        except ValueError as e:
            print(f"[study] W={W} N={N}: SKIP ({e})", flush=True)
            results[spec] = f"skipped: {e}"
            continue
        print(f"[study] W={W} N={N}: {msg}", flush=True)
        results[spec] = r
    return results


def main(argv=None):
    args = parse_args(argv)
    resolve_device(args.device)
    cwd = os.getcwd()
    with contextlib.ExitStack() as stack:
        # Keep the artifact dumps of a fresh build out of the caller's
        # directory.
        workdir = args.warm_dir or stack.enter_context(
            tempfile.TemporaryDirectory())
        os.chdir(workdir)
        stack.callback(os.chdir, cwd)
        hrom = build(args)
        t0 = time.perf_counter()
        uh_fom, uh_hom = validation_fom(
            hrom, cache=FOM_CACHE if args.warm_dir else None)
        print(f"[study] FOM reference solve: {time.perf_counter() - t0:.1f}s",
              flush=True)
        return study(hrom, args, uh_fom, uh_hom)


if __name__ == "__main__":
    main()
