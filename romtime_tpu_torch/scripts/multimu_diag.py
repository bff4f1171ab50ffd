"""Multi-μ windowed-serving error decomposition (counterpart of
``scripts/multimu_diag.py``).

For each held-out validation μ, splits the served-vs-FOM error into the
component inside the per-window basis span (ROM dynamics and
hyper-reduction error) and the orthogonal component (the projection
floor of that trajectory, the best any ROM on these bases can do):

    err = u_served − u_fom,  u_served ∈ span(V_w) + lifting
    ⇒ (I − P_w) err = −(I − P_w) (u_fom − g) = projection floor part.

    python -m romtime_tpu_torch.scripts.multimu_diag <warm_dir> [n_mu]
        [--device cpu]
    python -m romtime_tpu_torch.scripts.multimu_diag <dir> [n_mu] --cold
        --snapshots 8 [--windows 30] [--window-n 40] [--nmdeim 48]
        [--tri-snapshots 3]

with the JAX script's flags (``--rebuild``, ``--train-box``,
``--train-corners``, ``--mulocal``, ``--per-cell``, ``--aug``,
``--aug-weight``, ``--edges``, ``--srom-extra``, ``--cell-wn``).
``--cold`` rebuilds the offline pipeline in <dir>, persisting the
artifacts for later warm runs. A warm directory whose resume attached a
μ-local fleet is diagnosed on that fleet (routed, each μ on its cell's
windows), as ``permu_diag`` diagnoses it; the JAX script serves such a
directory on its active windows only. The FOM references are on each
lane's matched grid (T·d on a registered lane), cached in the
directory's ``fom_validation_multi.npz`` (``permu_diag``'s cache).
The JAX script's platform pinning has no counterpart here.
"""

import argparse
import itertools
import os
import time

import numpy as np
import torch

from ..conventions import Stage
from ..dtypes import compute_dtype_scope
from ..utils.cli import add_device_argument, resolve_device
from .permu_diag import FOM_CACHE, fom_references, validation_mus

#: The bench's single-μ certification point (bench.py ``mu_val``), the
#: last row of the multi-μ scan.
CENTER_MU = dict(a0=9.3, omega=17.5, delta=0.12, alpha=1e-6, gamma=1.4)


def parse_args(argv=None):
    ap = add_device_argument(argparse.ArgumentParser(description=__doc__))
    ap.add_argument("dir", nargs="?", default=".bench_warm")
    ap.add_argument("n_mu", nargs="?", type=int, default=16)
    ap.add_argument("--cold", action="store_true")
    ap.add_argument("--rebuild", action="store_true",
                    help="warm-resume the basis but re-project the "
                         "windowed serving at the requested (W, N) from "
                         "the retained offline snapshots")
    ap.add_argument("--snapshots", type=int, default=3)
    ap.add_argument("--windows", type=int, default=30)
    ap.add_argument("--window-n", type=int, default=40)
    ap.add_argument("--nmdeim", type=int, default=48)
    ap.add_argument("--tri-snapshots", type=int, default=2)
    ap.add_argument("--srom-modes", type=int, default=96)
    ap.add_argument("--train-box", default=None,
                    help="restrict the training grid to a sub-box, e.g. "
                         "'a0:8.0:8.6,omega:19:20,delta:0.135:0.15' "
                         "(validation μ still come from the full box)")
    ap.add_argument("--train-corners", action="store_true",
                    help="with --train-box: train at the 8 sub-box corners "
                         "and the center instead of random samples")
    ap.add_argument("--mulocal", type=int, default=0,
                    help="build K Mach-cell mu-local serving (warm resume "
                         "+ per-cell top-up FOM solves) and validate "
                         "through solve_batch_mulocal")
    ap.add_argument("--per-cell", type=int, default=10,
                    help="training trajectories per mu-local cell")
    ap.add_argument("--aug", type=int, default=0,
                    help="box-wide trajectories appended to every cell "
                         "stack (-1 = all retained)")
    ap.add_argument("--aug-weight", type=float, default=1.0)
    ap.add_argument("--edges", default=None,
                    help="custom Mach cell edges, e.g. '0.15,0.25,0.33,0.4'"
                         " (overrides --mulocal count)")
    ap.add_argument("--srom-extra", type=int, default=0,
                    help="per-cell sacrificial estimator modes (N+extra)")
    ap.add_argument("--cell-wn", default=None,
                    help="mixed-(W,N) fleet, e.g. '50x32,50x32,50x32,30x40'"
                         " — one WxN per Mach cell")
    return ap.parse_args(argv)


def hrom_arguments(args, nx=1000, nt=1500):
    """``HyperReducedPiston``'s keyword arguments of the JAX script's
    configuration (nx=1000, nt=1500, the flags' snapshot and mode
    counts), on ``args.device``."""
    from ..problems import piston_profile

    return piston_profile(nx=nx, nt=nt, n_offline=args.snapshots,
                          modes=args.srom_modes, truncate=8,
                          nmdeim=args.nmdeim, tri_mu=args.tri_snapshots,
                          device=str(resolve_device(args.device)))


def training_mus(args, grid):
    """The cold build's training μ under ``--train-box`` (its corners and
    center with ``--train-corners``, else ``args.snapshots`` seeded
    draws from the sub-box), or None for the default sampler."""
    from ..parameters import ParameterSampler, get_uniform_dist

    if not args.train_box:
        return None
    box = {}
    for part in args.train_box.split(","):
        name, lo, hi = part.split(":")
        box[name] = get_uniform_dist(min=float(lo), max=float(hi))
    for name, dist in grid.items():
        box.setdefault(name, dist)
    names = ("a0", "omega", "delta")
    if args.train_corners:
        rng = {n: (min(box[n].support()), max(box[n].support()))
               for n in names}
        mus = [dict({"alpha": 1e-6, "gamma": 1.4},
                    **{n: rng[n][b] for b, n in zip(bits, names)})
               for bits in itertools.product((0, 1), repeat=3)]
        mus.append(dict({"alpha": 1e-6, "gamma": 1.4},
                        **{n: 0.5 * (rng[n][0] + rng[n][1]) for n in names}))
    else:
        mus = [dict(m) for m in ParameterSampler(
            box, n_iter=args.snapshots,
            random_state=np.random.RandomState(0))]
    for m in mus:
        print("[diag] train mu: " + " ".join(
            f"{k}={m[k]:.3f}" for k in names), flush=True)
    return mus


def build(args):
    """The HROM in ``args.dir``: the cold build (and its dumps) or the
    warm resume (re-projecting the windows with ``--rebuild``), then the
    μ-local fleet with ``--mulocal``. Returns (hrom, fleet or None)."""
    from ..rom.hrom import HyperReducedPiston

    os.makedirs(args.dir, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(args.dir)
    try:
        t0 = time.perf_counter()
        kwargs = hrom_arguments(args)
        hrom = HyperReducedPiston(**kwargs)
        hrom.setup()
        hrom.setup_hyperreduction()
        if args.cold:
            hrom.run_offline_rom(mu_space=training_mus(args, kwargs["grid"]))
            hrom.run_offline_hyperreduction(
                mu_space=hrom.mu_space[Stage.OFFLINE], evaluate=False)
            hrom.project_reductors()
            hrom.dump_mu_space()
            hrom.dump_reduced_basis()
            hrom.dump_offline_snapshots()
            hrom.build_windowed_serving(n_windows=args.windows,
                                        num_basis=args.window_n)
            print(f"[diag] cold offline {time.perf_counter() - t0:.1f}s "
                  f"(snapshots={args.snapshots})", flush=True)
        else:
            hrom.start_from_existing_basis()
            hrom.project_reductors()
            if args.rebuild:
                hrom.rom.windows = None
                hrom.build_windowed_serving(n_windows=args.windows,
                                            num_basis=args.window_n)
            print(f"[diag] warm resume {time.perf_counter() - t0:.1f}s",
                  flush=True)
        ml = hrom.rom.mulocal
        if args.mulocal:
            t1 = time.perf_counter()
            ml = hrom.build_mulocal_serving(
                n_cells=args.mulocal, n_windows=args.windows,
                num_basis=args.window_n, snapshots_per_cell=args.per_cell,
                rnd=np.random.RandomState(11),
                augment_global=(True if args.aug < 0 else args.aug),
                augment_weight=args.aug_weight,
                edges=([float(x) for x in args.edges.split(",")]
                       if args.edges else None),
                srom_extra=args.srom_extra or None,
                cell_wn=([tuple(int(v) for v in s.split("x"))
                          for s in args.cell_wn.split(",")]
                         if args.cell_wn else None))
            print(f"[diag] mulocal K={ml.n_cells} edges="
                  f"{np.round(ml.edges, 3)} built in "
                  f"{time.perf_counter() - t1:.1f}s", flush=True)
    finally:
        os.chdir(cwd)
    return hrom, ml


def decompose(u, ref, bounds, Vs):
    """The rel / floor / in-span split of one lane's error on the device:
    ``u`` and ``ref`` (nh, nt) served and FOM trajectories, ``bounds``
    (W+1,) and ``Vs`` (W, nh, N) its windows. err = u − ref; per window
    the part of err outside span(V_w) is the projection floor.
    Returns (rel, floor, inspace) over ‖ref‖, with rel² = floor² +
    inspace² (inspace clamped at 0)."""
    err = u - ref
    nrm = torch.linalg.norm(ref)
    floor2 = err.new_zeros(())
    for w in range(len(Vs)):
        a, b = int(bounds[w]), int(bounds[w + 1])
        V = Vs[w]
        seg = err[:, a:b]
        floor2 = floor2 + torch.linalg.norm(seg - V @ (V.T @ seg)) ** 2
    err2 = torch.linalg.norm(err) ** 2
    return (float(torch.sqrt(err2) / nrm), float(torch.sqrt(floor2) / nrm),
            float(torch.sqrt(torch.clamp(err2 - floor2, min=0.0)) / nrm))


def diagnose(hrom, mus, ml, cache):
    """The decomposition rows of ``mus``: served in float64 through the
    windowed lanes engine (routed over ``ml`` where it is a fleet, else
    on the active windows), each against its matched-grid FOM reference
    (:func:`~.permu_diag.fom_references`, cached at ``cache``), on the
    ROM's device. Returns a list of {"rel", "floor", "inspace", "cell",
    "dil", "mu"}."""
    from ..rom.rom import RomConstructorNonlinear as RCN

    rom = hrom.rom
    t0 = time.perf_counter()
    with compute_dtype_scope(torch.float64):
        if ml is not None:
            outs = rom.solve_batch_mulocal([dict(m) for m in mus],
                                           step=Stage.VALIDATION,
                                           mode="full", engine="windowed")
        else:
            outs = rom.solve_batch([dict(m) for m in mus],
                                   step=Stage.VALIDATION, mode="full",
                                   engine="windowed")
    print(f"[diag] windowed validation sweep {time.perf_counter() - t0:.1f}s",
          flush=True)
    dils = np.asarray(outs.get("dil", np.ones(len(mus))), np.float64)
    refs = fom_references(hrom, mus, dils, cache)
    device = rom.device
    rows = []
    for i, m in enumerate(mus):
        cell = (int(ml.cell_of(RCN.compute_piston_mach_number(m)))
                if ml is not None else None)
        win = ml.cells[cell] if ml is not None else rom.windows
        Vs = torch.as_tensor(np.asarray(win.Vs), dtype=torch.float64,
                             device=device)
        u = torch.as_tensor(np.asarray(outs["uc"][i]).T, device=device)
        ref = torch.as_tensor(refs[i], device=device)
        rel, floor, inspace = decompose(u, ref, win.bounds, Vs)
        rows.append(dict(rel=rel, floor=floor, inspace=inspace, cell=cell,
                         dil=float(dils[i]), mu=dict(m)))
    return rows


def print_rows(rows):
    print(f"[diag] {'a0':>6} {'omega':>6} {'delta':>6}  "
          f"{'rel':>9} {'floor':>9} {'inspace':>9}", flush=True)
    for r in rows:
        m = r["mu"]
        print(f"[diag] {m['a0']:6.2f} {m['omega']:6.2f} {m['delta']:6.3f}  "
              f"{r['rel']:9.2e} {r['floor']:9.2e} {r['inspace']:9.2e}",
              flush=True)
    rels = np.array([r["rel"] for r in rows])
    floors = np.array([r["floor"] for r in rows])
    print(f"[diag] rel    mean {rels.mean():.2e} max {rels.max():.2e}",
          flush=True)
    print(f"[diag] floor  mean {floors.mean():.2e} max {floors.max():.2e}",
          flush=True)


def main(argv=None):
    args = parse_args(argv)
    resolve_device(args.device)
    hrom, ml = build(args)
    win = ml.cells[0] if ml is not None else hrom.rom.windows
    if win is None:
        raise ValueError("the directory has no windowed serving "
                         "configuration")
    print(f"[diag] W={win.n_windows} N={win.N}", flush=True)
    mus = validation_mus(hrom.rom, args.n_mu) + [dict(CENTER_MU)]
    rows = diagnose(hrom, mus, ml, os.path.join(args.dir, FOM_CACHE))
    print_rows(rows)
    return rows


if __name__ == "__main__":
    main()
