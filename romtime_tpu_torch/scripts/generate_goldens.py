"""The heat HROM's golden error-statistics table (counterpart of
``scripts/generate_goldens.py``): per μ {mean, median, max, min} of the
online ROM-vs-FOM error series for a 20-point μ sample, from the
deterministic heat HROM pipeline of ``tests/test_hrom.py``
``_heat_config`` (``RandomState(0)`` offline, ``RandomState(5)`` online
sample), built and evaluated by the port.

    python -m romtime_tpu_torch.scripts.generate_goldens [--out FILE]
        [--device cpu]

Writes ``--out`` (default ``heat_hrom_online_stats.json`` in the working
directory); the repository's pinned table in ``tests/goldens/`` is the
JAX package's and is never written here. The pipeline's dumps go to a
temporary directory, removed after.
"""

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from ..conventions import Errors, Stage
from ..dtypes import compute_dtype_scope
from ..utils.cli import add_device_argument, resolve_device

DEFAULT_OUT = "heat_hrom_online_stats.json"
#: The online μ sample's size (the pinned table's rows).
NUM = 20


def heat_config(nx=80, nt=50, tf=10.0, L=2.0, moving=False):
    """tests/test_hrom.py ``_heat_config`` with the port's callables: the
    heat HROM's keyword arguments (MFP1, 4 offline μ, the S-ROM
    truncated by 2, DEIM and MDEIM on 6 μ over every step)."""
    from ..conventions import OperatorType, RomParameters
    from ..parameters import get_uniform_dist
    from ..problems import define_mfp1_problem

    domain, bcs, forcing, u0, ue, Lt, dLt_dt = define_mfp1_problem(L, nx, tf,
                                                                   nt)
    grid = {"delta": get_uniform_dist(min=0.01, max=2.0),
            "beta": get_uniform_dist(min=1.0, max=10.0),
            "alpha_0": get_uniform_dist(min=0.01, max=2.0)}
    if moving:
        omegas = [(1.0 / tf) * np.arcsin(1.0 - n) for n in (0.5, 0.8)]
        grid["omega"] = get_uniform_dist(min=min(omegas), max=max(omegas))
    fom_params = dict(domain=domain, dirichlet=bcs, forcing_term=forcing,
                      u0=u0, exact_solution=ue,
                      grid_params={k: "uniform" for k in grid})
    if moving:
        fom_params.update(Lt=Lt, dLt_dt=dLt_dt)
    ts = np.linspace(tf / nt, tf, nt)
    return dict(
        grid=grid, fom_params=fom_params,
        rom_params={RomParameters.NUM_SNAPSHOTS: 4,
                    RomParameters.SROM_TRUNCATE: 2,
                    RomParameters.TOL_TIME: None,
                    RomParameters.TOL_MU: None},
        deim_params={RomParameters.TS: ts, RomParameters.NUM_SNAPSHOTS: 6},
        mdeim_params={RomParameters.TS: ts, RomParameters.NUM_SNAPSHOTS: 6},
        models={OperatorType.MASS: True, OperatorType.STIFFNESS: True,
                OperatorType.RHS: True, OperatorType.CONVECTION: moving})


def online_stats(device="cuda"):
    """Build the fixed heat HROM of :func:`heat_config` on ``device`` in
    a temporary directory, evaluate it online on :data:`NUM` μ
    (``RandomState(5)``) against the FOM (no manufactured solution), in
    float64, and return {str(μ index): {"mean", "median", "max",
    "min"}} of each μ's ROM error series."""
    from ..rom import HyperReducedOrderModelFixed

    device = str(resolve_device(device))
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp, \
            compute_dtype_scope(torch.float64):
        os.chdir(tmp)
        try:
            hrom = HyperReducedOrderModelFixed(
                **heat_config(), rnd=np.random.RandomState(0), device=device)
            hrom.setup()
            hrom.setup_hyperreduction()
            hrom.run_offline_rom()
            hrom.run_offline_hyperreduction(
                mu_space=hrom.mu_space[Stage.OFFLINE], evaluate=False)
            hrom.project_reductors()
            # The FOM-comparison path (no manufactured solution), the
            # reference's semantics; the JAX script also drops its jit
            # cache here, which has no counterpart.
            hrom.fom.exact_solution = None
            hrom.evaluate_online(params={"num": NUM},
                                 rnd=np.random.RandomState(5))
        finally:
            os.chdir(cwd)
    errors = hrom.errors[f"{Stage.ONLINE}-vs-fom"]
    table = {}
    for idx in sorted(errors):
        series = np.asarray(errors[idx][Errors.ROM])
        table[str(idx)] = {"mean": float(series.mean()),
                           "median": float(np.median(series)),
                           "max": float(series.max()),
                           "min": float(series.min())}
    return table


def main(argv=None):
    parser = add_device_argument(argparse.ArgumentParser(description=__doc__))
    parser.add_argument("--out", default=DEFAULT_OUT)
    args = parser.parse_args(argv)
    table = online_stats(args.device)
    out = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as fh:
        json.dump(table, fh, indent=2, sort_keys=True)
    print(f"wrote {out} ({len(table)} mu rows)")
    return table


if __name__ == "__main__":
    main()
