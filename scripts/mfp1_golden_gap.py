"""The MFP1 convergence study (tests/goldens/mfp1_convergence_*.csv:
L=2, nx=500, β=5, tf to 99% decay, nt 10/100/1000) through the JAX
package and the port on the CPU: each package's log10 error at tf, its
gap to the pinned golden row, and the gap between the two packages.

CPU only (it imports JAX; never run on the card's machine):

    env JAX_PLATFORMS=cpu python scripts/mfp1_golden_gap.py [--nts 1000]

``chip_smoke.py`` phase 14 holds the card's nt=1000 values against the
JAX package's printed here (``HEAT_REF_LOG10``).
"""

import argparse
import csv
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def golden(moving):
    name = f"mfp1_convergence_{'moving' if moving else 'fixed'}.csv"
    with open(os.path.join(REPO, "tests", "goldens", name)) as fh:
        return {int(r["nt"]): float(r["log10_error"])
                for r in csv.DictReader(fh)}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--nts", type=int, nargs="+", default=[10, 100, 1000])
    args = parser.parse_args()

    import jax
    import torch

    jax.config.update("jax_enable_x64", True)
    from romtime_tpu.fom import HeatEquationMovingSolver as RefMoving
    from romtime_tpu.fom import HeatEquationSolver as RefFixed
    from romtime_tpu.problems import define_mfp1_problem as ref_define
    from romtime_tpu_torch.convert import heat_fom
    from romtime_tpu_torch.dtypes import compute_dtype_scope

    beta = 5.0
    tf = -np.log(1.0 - 0.99) / beta
    for moving in (False, True):
        mu = dict(delta=1.0, beta=beta, alpha_0=1.0)
        if moving:
            mu["omega"] = 2.0 * np.pi / (8.0 * tf)
        pinned = golden(moving)
        for nt in args.nts:
            domain, bcs, forcing, u0, ue, Lt, dLt_dt = ref_define(2.0, 500,
                                                                  tf, nt)
            extra = dict(Lt=Lt, dLt_dt=dLt_dt) if moving else {}
            ref = (RefMoving if moving else RefFixed)(
                domain=domain, dirichlet=bcs, parameters=mu,
                forcing_term=forcing, u0=u0, exact_solution=ue, **extra)
            ref.setup()
            ref.solve()
            port = heat_fom(2.0, 500, tf, nt, moving=moving, device="cpu")
            port.update_parametrization(mu)
            with compute_dtype_scope(torch.float64):
                port.solve()
            lg_ref = float(np.log10(ref.errors[ref.timesteps[-1]]))
            lg_port = float(np.log10(port.errors[port.timesteps[-1]]))
            print(f"{'moving' if moving else 'fixed'} nt={nt}: JAX package "
                  f"{lg_ref!r} (golden {pinned[nt]!r}, gap "
                  f"{abs(lg_ref - pinned[nt]):.3e}); port {lg_port!r} "
                  f"(gap to the JAX package {abs(lg_port - lg_ref):.3e})")


if __name__ == "__main__":
    main()
