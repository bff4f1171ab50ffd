"""Per-μ registered-fleet diagnostics on a warm build directory
(counterpart of ``scripts/permu_diag.py``).

Prints, for each held-out validation μ: its Mach cell, fitted dilation,
matched-grid rel-L2 against the FOM, and the S-ROM estimator/true ratio,
the row-level view behind the bench's ``rel_l2_multi_mu`` and
``windowed_estimator`` summaries. The FOM references are cached in the
directory's ``fom_validation_multi.npz`` (the JAX script's keys).

    BENCH_DIR=DIR python -m romtime_tpu_torch.scripts.permu_diag
        [--device cpu]

``BENCH_DIR`` (default ``.bench_warm``), ``BENCH_NX`` (1000),
``BENCH_NT`` (1500) and ``BENCH_MULTI_MU`` (16) as the JAX script reads
them. The JAX script's platform pinning and compilation cache
(``permu_diag.py:27-41``) have no counterpart here, nor have its
jit-cache resets (``rom._online_fns = {}``, ``fom._solve_jit = {}``).
"""

import argparse
import os
import time

import numpy as np
import torch

from ..conventions import Errors, PistonParameters, Stage, StorageNames
from ..dtypes import compute_dtype_scope
from ..utils.cli import add_device_argument, resolve_device

#: The FOM reference cache in the build directory (the JAX script's).
FOM_CACHE = "fom_validation_multi.npz"


def build_hrom(workdir, profile=None, device="cuda"):
    """Warm-resume the piston HROM from the build directory ``workdir``
    with ``profile``, ``HyperReducedPiston``'s keyword arguments (default
    ``problems.joint_profile()``, the bench's flagship configuration at
    nx=1000, nt=1500), on ``device``: set-up, the resume
    (``start_from_existing_basis``: bases, reductors, windows, the fleet,
    the offline snapshots) and the projection. Shared by the per-μ,
    multi-μ and corner-attribution diagnostics and the kernel ledger."""
    from ..problems import joint_profile
    from ..rom.hrom import HyperReducedPiston

    device = str(resolve_device(device))
    profile = dict(joint_profile() if profile is None else profile,
                   device=device)
    if not os.path.exists(os.path.join(workdir, StorageNames.SROM)):
        raise FileNotFoundError(f"no warm artifacts in {workdir}")
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        t0 = time.perf_counter()
        hrom = HyperReducedPiston(**profile)
        hrom.setup()
        hrom.setup_hyperreduction()
        hrom.start_from_existing_basis()
        hrom.project_reductors()
    finally:
        os.chdir(cwd)
    ml = hrom.rom.mulocal
    print(f"[{time.perf_counter() - t0:.1f}s] warm resume done; "
          f"cells={None if ml is None else ml.n_cells}")
    return hrom


def validation_mus(rom, n):
    """The first ``n`` of ``n`` Mach-stratified μ (``RandomState(7)``),
    the Mach key dropped (the JAX script's held-out set)."""
    mus = list(rom.build_sampling_space(num=n,
                                        rnd=np.random.RandomState(7)))[:n]
    return [{k: float(v) for k, v in m.items()
             if k != PistonParameters.MACH_PISTON} for m in mus]


def fom_references(hrom, mus, dils, path):
    """Each μ's float64 FOM trajectory (nh, nt) on its matched grid (T·d,
    the same nt steps), read from the npz at ``path`` when it holds the
    same grid, μ and dilations, else solved as one ``solve_fom_batch`` on
    the FOM's device and written there (keys ``uh``, ``nx``, ``nt``,
    ``mu``, ``dil``). (B, nh, nt)."""
    from ..parallel import solve_fom_batch

    fom = hrom.fom
    nx, nt = int(fom.domain[fom.NX]), int(fom.domain[fom.NT])
    key = np.array([[float(m[k]) for k in sorted(m)] for m in mus])
    dils = np.asarray(dils, np.float64)
    if os.path.exists(path):
        with np.load(path) as d:
            cached_dil = (np.asarray(d["dil"], np.float64)
                          if "dil" in d else np.ones(len(d["uh"])))
            if (int(d["nx"]) == nx and int(d["nt"]) == nt
                    and d["mu"].shape == key.shape
                    and np.allclose(d["mu"], key)
                    and cached_dil.shape == dils.shape
                    and np.allclose(cached_dil, dils)):
                return d["uh"]
    print("solving FOM refs on matched grids")
    with compute_dtype_scope(torch.float64):
        uc = solve_fom_batch(fom, mus, dilations=dils)["uc"]
    refs = np.ascontiguousarray(np.transpose(uc, (0, 2, 1)))
    np.savez(path, uh=refs, nx=nx, nt=nt, mu=key, dil=dils)
    return refs


def per_mu_rows(hrom, mus, cache):
    """The diagnostic rows of ``mus`` on the attached fleet: the routed
    ``solve_batch_mulocal(mode="full", engine="windowed")`` and
    ``estimate_batch_mulocal`` in float64 against the matched-grid FOM
    references (:func:`fom_references`, cached at ``cache``). Returns a
    list of {"mach", "cell", "dil", "rel", "ratio", "mu"}."""
    rom = hrom.rom
    with compute_dtype_scope(torch.float64):
        outs = rom.solve_batch_mulocal([dict(m) for m in mus],
                                       step=Stage.VALIDATION, mode="full",
                                       engine="windowed")
        est = hrom.estimate_batch_mulocal([dict(m) for m in mus],
                                          step=Stage.VALIDATION)
    dils = np.asarray(outs.get("dil", np.ones(len(mus))), np.float64)
    mach = [rom.compute_piston_mach_number(m) for m in mus]
    cells = np.asarray(rom.mulocal.cell_of(mach), int)
    refs = fom_references(hrom, mus, dils, cache)
    rows = []
    for i, m in enumerate(mus):
        uh_i = np.asarray(outs["uc"][i]).T
        diff = np.linalg.norm(uh_i - refs[i])
        rel = float(diff / np.linalg.norm(refs[i]))
        true_rms = diff / np.sqrt(uh_i.size)
        est_rms = float(np.sqrt(np.mean(
            np.asarray(est[Errors.ESTIMATOR][i]) ** 2)))
        rows.append(dict(mach=float(mach[i]), cell=int(cells[i]),
                         dil=float(dils[i]), rel=rel,
                         ratio=est_rms / max(true_rms, 1e-300), mu=dict(m)))
    return rows


def print_rows(rows):
    print(f"{'i':>2} {'mach':>6} {'cell':>4} {'dil':>7} {'relL2':>10} "
          f"{'est/true':>9}  mu")
    for i, r in enumerate(rows):
        m = r["mu"]
        print(f"{i:>2} {r['mach']:6.3f} {r['cell']:>4} {r['dil']:7.4f} "
              f"{r['rel']:10.3e} {r['ratio']:9.2f}  "
              f"a0={m['a0']:.3f} w={m['omega']:.3f} d={m['delta']:.4f}")
    rels = [r["rel"] for r in rows]
    rats = [r["ratio"] for r in rows]
    print(f"mean {np.mean(rels):.3e} max {np.max(rels):.3e} "
          f"ratio [{np.min(rats):.2f}, {np.max(rats):.2f}]")


def main(argv=None):
    from ..problems import joint_profile

    parser = add_device_argument(argparse.ArgumentParser(description=__doc__))
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    workdir = os.environ.get("BENCH_DIR", ".bench_warm")
    nx = int(os.environ.get("BENCH_NX", 1000))
    nt = int(os.environ.get("BENCH_NT", 1500))
    n_multi = int(os.environ.get("BENCH_MULTI_MU", 16))
    hrom = build_hrom(workdir, joint_profile(nx=nx, nt=nt), device)
    rows = per_mu_rows(hrom, validation_mus(hrom.rom, n_multi),
                       os.path.join(workdir, FOM_CACHE))
    print_rows(rows)
    return rows


if __name__ == "__main__":
    main()
