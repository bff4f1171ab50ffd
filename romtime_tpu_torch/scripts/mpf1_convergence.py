"""MFP1 time-step convergence study (counterpart of
``scripts/mpf1_convergence.py``): sweeps nt, solves the manufactured heat
problem with the port's heat FOM in float64, and reports the
exact-solution error at t = tf per refinement level.

    python -m romtime_tpu_torch.scripts.mpf1_convergence [--moving]
        [--nx 500] [--tf 10] [--L 2] [--nts 10 50 ...] [--csv FILE]
        [--device cpu]

The CSV has the JAX script's columns (``nt,dt,error_tf,log10_error``),
written with the ``csv`` module (no pandas on the card's machine).
"""

import argparse
import csv

import numpy as np
import torch

from ..dtypes import compute_dtype_scope
from ..utils.cli import add_device_argument, resolve_device

#: The CSV's columns (the JAX script's DataFrame: index ``nt``).
COLUMNS = ("nt", "dt", "error_tf", "log10_error")


def study_mu(tf, moving):
    """The study's μ (the JAX script's): δ = 1, β = 5, α₀ = 1, and on the
    moving domain ω = 2π / (8 tf)."""
    mu = dict(delta=1.0, beta=5.0, alpha_0=1.0)
    if moving:
        mu["omega"] = 2.0 * np.pi / (8.0 * tf)
    return mu


def solve_row(nt, nx=500, tf=10.0, L=2.0, moving=False, device="cuda"):
    """One refinement level: {"nt", "dt", "error_tf", "log10_error"} of
    the float64 FOM (``HeatEquationSolver`` or
    ``HeatEquationMovingSolver``) on ``device``."""
    from ..fom import HeatEquationMovingSolver, HeatEquationSolver
    from ..problems import define_mfp1_problem

    device = resolve_device(device)
    domain, bcs, forcing, u0, ue, Lt, dLt_dt = define_mfp1_problem(
        L, nx, tf, nt)
    common = dict(domain=domain, dirichlet=bcs,
                  parameters=study_mu(tf, moving), forcing_term=forcing,
                  u0=u0, exact_solution=ue, device=str(device))
    if moving:
        solver = HeatEquationMovingSolver(Lt=Lt, dLt_dt=dLt_dt, **common)
    else:
        solver = HeatEquationSolver(**common)
    solver.setup()
    with compute_dtype_scope(torch.float64):
        solver.solve()
    err_tf = float(solver.errors[solver.timesteps[-1]])
    return dict(nt=nt, dt=tf / nt, error_tf=err_tf,
                log10_error=float(np.log10(err_tf)))


def convergence_rows(nts, **kw):
    """:func:`solve_row` for each nt of ``nts``, in order."""
    return [solve_row(nt, **kw) for nt in nts]


def observed_rates(rows):
    """log(e_k / e_{k+1}) / log(nt_{k+1} / nt_k) between consecutive
    rows: ~1 for the first-order scheme."""
    errs = np.array([r["error_tf"] for r in rows])
    nts = np.array([r["nt"] for r in rows], float)
    return np.log(errs[:-1] / errs[1:]) / np.log(nts[1:] / nts[:-1])


def write_csv(rows, path):
    with open(path, "w", newline="") as fh:
        writer = csv.writer(fh)
        writer.writerow(COLUMNS)
        for r in rows:
            writer.writerow([r[c] for c in COLUMNS])


def main(argv=None):
    parser = add_device_argument(argparse.ArgumentParser(description=__doc__))
    parser.add_argument("--nx", type=int, default=500)
    parser.add_argument("--tf", type=float, default=10.0)
    parser.add_argument("--L", type=float, default=2.0)
    parser.add_argument("--moving", action="store_true")
    parser.add_argument("--nts", type=int, nargs="+",
                        default=[10, 50, 100, 500, 1000, 5000])
    parser.add_argument("--csv", type=str, default=None)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    rows = []
    for nt in args.nts:
        row = solve_row(nt, nx=args.nx, tf=args.tf, L=args.L,
                        moving=args.moving, device=device)
        rows.append(row)
        print(f"nt={nt:6d}  dt={row['dt']:.4e}  "
              f"log10 err(tf) = {row['log10_error']:+.4f}")
    if args.csv:
        write_csv(rows, args.csv)
        print(f"wrote {args.csv}")
    # First-order-in-time scheme: halving dt should ~halve the error.
    print("observed convergence rates:", np.round(observed_rates(rows), 2))
    return rows


if __name__ == "__main__":
    main()
