"""Attribute the high-Mach corner's served error to its in-span sources
(counterpart of ``scripts/corner_attrib.py``).

The corner row of the bench's 16-μ certification (a0=8.019,
omega=19.846, delta=0.1491, cell 5) serves with an error that is in the
span of its windows and shared by the ROM and the S-ROM. The shared
inputs are the hyper-reduction θ (DEIM-RHS, the MDEIMs, the nonlinear
lifting). This measures each reductor's interpolation error at the
corner μ over the (dilated) serving time grid, in the nnz-vector
convention: ``_interpolate`` (pre-scatter) against the exact assembled
snapshot, what the serving θ streams consume each step.

    BENCH_DIR=DIR python -m romtime_tpu_torch.scripts.corner_attrib
        [--device cpu]

The JAX script's platform pinning and compilation cache
(``corner_attrib.py:26-35``) have no counterpart here.
"""

import argparse
import os

import numpy as np
import torch

from ..dtypes import compute_dtype_scope
from ..utils.cli import add_device_argument, resolve_device
from .permu_diag import build_hrom

#: The corner μ and its fitted law's dilation (cell 5 of the bench's
#: fleet), the JAX script's.
CORNER_MU = dict(a0=8.019263506488011, omega=19.845792266348,
                 delta=0.14908754553066, alpha=1e-6, gamma=1.4)
CORNER_DIL = 1.0153979623527734
#: The reductors attributed (HyperReducedPiston attributes).
REDUCTORS = ("deim_rhs", "mdeim_mass", "mdeim_stiffness",
             "mdeim_convection", "mdeim_trilinear_lifting")


def attribution_times(fom, dil=CORNER_DIL, n_times=40):
    """Every (nt // n_times)-th step's time on the grid dilated by
    ``dil`` (the JAX script's 40)."""
    nt = int(fom.domain[fom.NT])
    return np.arange(1, nt + 1, nt // n_times) * float(fom.dt) * dil


def attribute(hrom, mu=CORNER_MU, dil=CORNER_DIL, n_times=40):
    """{reductor: (the relative interpolation errors ‖exact − approx‖ /
    ‖exact‖ at each time of :func:`attribution_times`)} for each trained
    reductor of :data:`REDUCTORS`."""
    ts = attribution_times(hrom.fom, dil, n_times)
    out = {}
    for name in REDUCTORS:
        red = getattr(hrom, name, None)
        if red is None:
            continue
        errs = []
        # float64, as the JAX script evaluates under its x64 default.
        with compute_dtype_scope(torch.float64):
            for t in ts:
                exact = np.asarray(red.assemble_snapshot(mu, float(t)))
                approx = np.asarray(red._interpolate(mu, float(t),
                                                     which=red.FOM))
                den = max(np.linalg.norm(exact), 1e-300)
                errs.append(np.linalg.norm(exact - approx) / den)
        out[name] = np.array(errs)
    return out


def main(argv=None):
    from ..problems import joint_profile

    parser = add_device_argument(argparse.ArgumentParser(description=__doc__))
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    nx = int(os.environ.get("BENCH_NX", 1000))
    nt = int(os.environ.get("BENCH_NT", 1500))
    hrom = build_hrom(os.environ.get("BENCH_DIR", ".bench_warm"),
                      joint_profile(nx=nx, nt=nt), device)
    errs = attribute(hrom)
    for name, e in errs.items():
        print(f"nnz {name:18s}: mean {np.mean(e):.3e} max {np.max(e):.3e}")
    return errs


if __name__ == "__main__":
    main()
