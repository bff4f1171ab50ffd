"""The built top cell held against the JAX package on the CPU: faults F7,
F8 and F9 of the port's fleet (ROADMAP Queue 3).

This script imports JAX and the JAX package ``romtime_tpu``, so it runs
on a CPU machine with JAX installed and never on the card's machine (the
one script of ``scripts/`` that may import JAX). Both packages run on
the CPU in float64 unless a step says float32.

Stages, each cached in the working directory (``--workdir``, default
``build/cpu_fleet_parity``) and reused by a later run unless
``--rebuild`` names it:

``port``
    The port builds phase 12's cut fleet (``chip_smoke.py``: the joint
    profile's global build at nx=1000, nt=1500, then
    ``build_mulocal_serving`` with 2,2,2,2,5,24 training μ, the top cell
    registered, cells 50x32 ×4 and 150x48 ×2, ``srom_extra=8``) on the
    CPU, its training sweep in float64, and dumps it (the fleet npz both
    packages read, ``MuLocalWindowed``).
``port32``
    The same port build with the fleet's training sweep in float32, as
    the card sweeps it (``HyperReducedPiston._sweep_fleet``), for F9.
``ref``
    The JAX package builds the same cut fleet on the CPU (its SVDs
    through numpy: the jax CPU SVD returns NaN spectra on some rank-1
    snapshot matrices under threaded OpenBLAS, ROADMAP Queue 3).
``serve``
    F7 and F8 on the top cell (cell 5, 150 windows of N=48): the lanes
    of scripts/paired_lu_probe.py (the batch μ of phase 12 (c), the
    cell's 24 training μ and 40 more of its μ, cycled to 128 lanes;
    ``--lanes`` takes the first n of them, cycled to 128), served on the
    port's fleet loaded into the JAX package:
    the JAX package's ``online_sweep_windowed_fused`` in interpret mode
    with ``ROMTIME_PAIRED_LU=5``/``ROMTIME_PAIRED_MODE=sub1`` and with
    ``ROMTIME_PAIRED_LU=0`` (the per-step LU), beside the port's twin
    on the same inputs; each against the JAX package's windowed lanes
    engine in float32 and float64 and the port's own.
``f9``
    F9: the two builds of cell 5 compared stage by stage (training μ in
    order, the dilation law, the window spans by principal angles), and
    the held-out μ's rel-L2 on the matched grid through each package's
    float64 lanes engine against its own float64 FOM, and through the
    port's build with the float32 training sweep.

Writes ``build/cpu_fleet_parity.json`` (the numbers are the CPU's).
Run from the repository root::

    env JAX_PLATFORMS=cpu python scripts/cpu_fleet_parity.py

About 45 minutes on 8 cores, ~9 GB of memory at its peak (``serve``).
``--small`` rehearses every stage at a tiny size (nx=100, nt=60, two
windows a cell) in a few minutes.
"""

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from romtime_tpu_torch.problems import joint_fleet, joint_profile  # noqa

T0 = time.perf_counter()
CELL = 5
#: phase 12's cut fleet (chip_smoke.py FLEET_BUILD_*).
GRID = dict(cs.FLEET_BUILD_GRID)
PER_CELL = tuple(cs.FLEET_BUILD_PER_CELL)
REGISTER = list(cs.FLEET_BUILD_REGISTER)
CELL_WN = tuple(cs.FLEET_BUILD_CELL_WN)
N_LANES = 128
OUT = os.path.join(REPO, "build", "cpu_fleet_parity.json")


def log(*a):
    print(f"[{time.perf_counter() - T0:8.1f}s]", *a, flush=True)


def fleet_kwargs():
    return joint_fleet(per_cell=PER_CELL, register=REGISTER, cell_wn=CELL_WN)


# ----------------------------------------------------------------------
# Stage "port": the port's build
# ----------------------------------------------------------------------
def _sweep_fleet_f32(self, cell_mus, cell_snaps, cell_nl, local_tri):
    """``HyperReducedPiston._sweep_fleet`` with the training sweep in
    float32, as the card sweeps it."""
    order = [(c, j) for c in sorted(cell_mus)
             for j in range(len(cell_mus[c]))]
    snaps, nls = self._sweep([cell_mus[c][j] for c, j in order],
                             torch.float32, local_tri)
    for b, (c, _j) in enumerate(order):
        cell_snaps[c].append(snaps[b])
        if local_tri:
            cell_nl[c].append(nls[b])
    return "device-f32"


def port_build(workdir, sweep_f32=False):
    """The port's global build and fleet in ``workdir`` (float64; with
    ``sweep_f32`` the fleet's training sweep in float32, the card's)."""
    import types

    os.makedirs(workdir, exist_ok=True)
    hrom, secs, _calls = cs.build_pipeline("cpu", GRID, workdir,
                                           profile="joint_profile")
    log("port global build", {k: round(v, 2) for k, v in secs.items()})
    if sweep_f32:
        hrom._sweep_fleet = types.MethodType(_sweep_fleet_f32, hrom)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        hrom.build_mulocal_serving(device_sweep=True, **fleet_kwargs())
    finally:
        os.chdir(cwd)
    log("port fleet build", {k: round(v, 2)
                             for k, v in hrom.fleet_seconds.items()})
    return hrom, dict(global_seconds=secs, fleet_seconds=hrom.fleet_seconds)


def port_resume(workdir):
    """The port's pipeline resumed from ``workdir``'s dumps, with each
    cell's training μ from the trajectory cache."""
    from romtime_tpu_torch.rom.hrom import HyperReducedPiston

    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        hrom = HyperReducedPiston(**joint_profile(device="cpu", **GRID))
        hrom.setup()
        hrom.setup_hyperreduction()
        hrom.start_from_existing_basis()
        hrom.project_reductors()
        hrom.cell_mus = cached_cell_mus("mulocal_snapshots.npz")
    finally:
        os.chdir(cwd)
    return hrom


def cached_cell_mus(path):
    with np.load(path) as d:
        keys = [str(k) for k in d["mu_keys"]]
        return {c: [dict(zip(keys, (float(x) for x in row)))
                    for row in d[f"mus_{c}"]]
                for c in range(len(d["per_cell"]))}


# ----------------------------------------------------------------------
# Stage "ref": the JAX package's build
# ----------------------------------------------------------------------
def _numpy_svd(a, full_matrices=False):
    return tuple(np.linalg.svd(np.asarray(a), full_matrices=full_matrices))


def jax_setup():
    """JAX in float64 on the CPU, its SVD through numpy."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)
    jnp.linalg.svd = _numpy_svd


def ref_hrom():
    """The JAX package's pipeline with the joint profile's settings
    (``problems.joint_profile``, bench.py:64-190) at ``GRID``."""
    from romtime_tpu.conventions import (
        OperatorType,
        PistonParameters,
        RomParameters,
    )
    from romtime_tpu.parameters import get_uniform_dist
    from romtime_tpu.problems import define_piston_problem
    from romtime_tpu.rom.hrom import HyperReducedPiston

    nx, nt, tf = GRID["nx"], GRID["nt"], GRID["tf"]
    domain, bcs, forcing, u0, Lt, dLt_dt = define_piston_problem(
        L=1.0, nx=nx, tf=tf, nt=nt)
    grid = {
        PistonParameters.A0: get_uniform_dist(min=8.0, max=10.0),
        PistonParameters.OMEGA: get_uniform_dist(min=15.0, max=20.0),
        PistonParameters.DELTA: get_uniform_dist(min=0.1, max=0.15),
        PistonParameters.ALPHA: get_uniform_dist(min=1e-6, max=1e-6),
        PistonParameters.GAMMA: get_uniform_dist(min=1.4, max=1.4),
    }
    port = joint_profile(device="cpu", **GRID)
    ts = np.linspace(tf / nt, tf, nt)
    ts_walk = ts[:: max(1, nt // 100)]
    walk = {RomParameters.TS: ts_walk,
            RomParameters.NUM_SNAPSHOTS: port["rom_params"][
                RomParameters.NUM_SNAPSHOTS]}
    return HyperReducedPiston(
        grid=grid,
        fom_params=dict(domain=domain, dirichlet=bcs, forcing_term=forcing,
                        u0=u0, Lt=Lt, dLt_dt=dLt_dt,
                        grid_params={k: "uniform" for k in grid}),
        rom_params=dict(port["rom_params"]), deim_params=dict(walk),
        mdeim_params=dict(walk),
        mdeim_nonlinear_params={
            RomParameters.TS: ts_walk[::4],
            RomParameters.NUM_SNAPSHOTS: port["mdeim_nonlinear_params"][
                RomParameters.NUM_SNAPSHOTS]},
        models={k: True for k in (
            OperatorType.MASS, OperatorType.STIFFNESS, OperatorType.RHS,
            OperatorType.CONVECTION, OperatorType.NONLINEAR_LIFTING,
            OperatorType.TRILINEAR)},
        rnd=np.random.RandomState(0))


def ref_build(workdir):
    """The JAX package's global build and fleet in ``workdir``: the
    port's sequence (``chip_smoke.build_pipeline``, then
    ``build_mulocal_serving(device_sweep=True)``), float64."""
    from romtime_tpu.conventions import Stage

    os.makedirs(workdir, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(workdir)
    secs = {}
    try:
        t0 = time.perf_counter()
        hrom = ref_hrom()
        hrom.setup()
        hrom.setup_hyperreduction()
        hrom.run_offline_rom(device_sweep=True)
        hrom.run_offline_hyperreduction(
            mu_space=hrom.mu_space[Stage.OFFLINE], evaluate=False)
        hrom.project_reductors()
        hrom.dump_mu_space()
        hrom.dump_reduced_basis()
        hrom.dump_offline_snapshots()
        secs["global"] = time.perf_counter() - t0
        log("ref global build", secs)
        t0 = time.perf_counter()
        hrom.build_mulocal_serving(device_sweep=True, **fleet_kwargs())
        secs["fleet"] = time.perf_counter() - t0
        log("ref fleet build", secs)
    finally:
        os.chdir(cwd)
    return hrom, secs


def ref_resume(workdir):
    """The JAX package's pipeline resumed from ``workdir``'s dumps (its
    own or the port's: both write the same files)."""
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        hrom = ref_hrom()
        hrom.setup()
        hrom.setup_hyperreduction()
        hrom.start_from_existing_basis()
        hrom.project_reductors()
        hrom.cell_mus = cached_cell_mus("mulocal_snapshots.npz")
    finally:
        os.chdir(cwd)
    return hrom


# ----------------------------------------------------------------------
# Stage "serve": F7 and F8 on the top cell
# ----------------------------------------------------------------------
def lane_mus(rom, ml, cell_mus, n_lanes):
    """The paired-LU probe's lanes on the top cell
    (``chip_smoke.probe_lanes``, phase 12 (c)'s batch), the first
    ``n_lanes`` cycled to 128 (the JAX
    package's kernel serves whole blocks of 128 lanes); and the counts."""
    from romtime_tpu_torch.testing import synthetic as synth

    batch = synth.synthetic_mus(cs.FLEET_BUILD_B, seed=61 + cs.FLEET_CALLS)
    lanes, distinct = cs.probe_lanes(rom, ml, CELL, batch, cell_mus[CELL])
    lanes = lanes[:n_lanes]
    lanes = (lanes * -(-cs.FLEET_LANES_B // len(lanes)))[:cs.FLEET_LANES_B]
    return lanes, dict(distinct=distinct, lanes=len(lanes),
                       first=n_lanes)


def gap(p, q):
    """Max |p − q| over (B, nt, 2) probes, and the worst steps."""
    g = np.abs(np.asarray(p, np.float64) - np.asarray(q, np.float64))
    steps = np.argsort(g.max(axis=(0, 2)))[-5:][::-1]
    return dict(max=float(g.max()), worst_steps=steps.tolist())


class _env:
    """Environment variables set inside the scope (None unsets)."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        for k, v in self.values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def adopt_dofs(red, dofs):
    """Give the JAX package's reductor ``red`` the interpolation entries
    ``dofs`` (its PᵀU and inverse from its own collateral basis); True
    where they differed."""
    dofs = [tuple(int(v) for v in d) for d in dofs]
    if [tuple(int(v) for v in d) for d in red.dofs] == dofs:
        return False
    if hasattr(red, "rows"):
        where = {(int(r), int(c)): i
                 for i, (r, c) in enumerate(zip(red.rows, red.cols))}
        pos = [where[d] for d in dofs]
    else:
        pos = [d[0] for d in dofs]
    red.dofs = dofs
    red.PT_U = np.asarray(red.basis_fom)[pos]
    red.PT_U_inv = np.linalg.inv(red.PT_U)
    red._batch_interpolate_fn = None
    red._evaluate_batch_fn = None
    red._combine_cache = {}
    return True


SCHEDULES = {"paired_G5_sub1": {"ROMTIME_PAIRED_LU": "5",
                                "ROMTIME_PAIRED_MODE": "sub1"},
             "per_step_lu": {"ROMTIME_PAIRED_LU": "0",
                             "ROMTIME_PAIRED_MODE": None}}


class _Captured(Exception):
    pass


def serve_stage(workdir, n_lanes):
    """F7 and F8 on the port's built top cell (module doc). The port's
    results are kept in ``<workdir>/serve_port.npz`` and reused."""
    import jax
    import jax.numpy as jnp

    import romtime_tpu.ops.pallas_online as po
    from romtime_tpu.conventions import Stage as RefStage
    from romtime_tpu.dtypes import compute_dtype_scope as ref_scope
    from romtime_tpu_torch.dtypes import compute_dtype_scope
    from romtime_tpu_torch.ops import windowed_fused as k1
    from romtime_tpu_torch.rom.engines import windowed_fused as engine

    port_dir = os.path.join(workdir, "port")
    cache = os.path.join(workdir, f"serve_port_{n_lanes}.npz")
    out = {}
    port = port_resume(port_dir)
    rom, ml = port.rom, port.rom.mulocal
    lanes, out["lane_groups"] = lane_mus(rom, ml, port.cell_mus, n_lanes)
    log("lanes", out["lane_groups"])
    rom._set_serving_windows(ml.cells[CELL])
    rom.ONLINE_PRECOMPUTE_BUDGET = 0
    with _env(ROMTIME_SOLVE_ITERS=None):
        out["auto_solve_iters"] = rom._windowed_solve_iters()

    # The port: served (its twin of K1 on the CPU) on both schedules, the
    # launch's inputs captured; the lanes engine in float32 and float64.
    captured = {}
    real = engine.online_sweep_windowed_fused
    have = os.path.exists(cache)
    port_res = dict(np.load(cache)) if have else {}
    for name, env in SCHEDULES.items():
        def spy(*a, **kw):
            captured[name] = (a, kw)
            if have:
                raise _Captured
            return real(*a, **kw)

        engine.online_sweep_windowed_fused = spy
        try:
            with _env(ROMTIME_SOLVE_ITERS="0", **env):
                t0 = time.perf_counter()
                try:
                    port_res[f"served_{name}"] = rom.solve_batch(
                        lanes, mode="probes")["probes"]
                except _Captured:
                    pass
                log("port served", name, f"{time.perf_counter() - t0:.1f} s")
        finally:
            engine.online_sweep_windowed_fused = real
    for label, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        if have:
            continue
        with compute_dtype_scope(dtype):
            t0 = time.perf_counter()
            port_res[f"lanes_{label}"] = rom.solve_batch(
                lanes, mode="probes", engine="windowed")["probes"]
            log("port lanes", label, f"{time.perf_counter() - t0:.1f} s")
    if not have:
        np.savez(cache, **port_res)
    period = captured["paired_G5_sub1"][1]["period"]
    width = int(captured["paired_G5_sub1"][1]["widths"][0])
    out["schedule"] = dict(width=width, period=period,
                           roles=k1.step_roles(period, 5),
                           interpret_chunk=po._chunk_capped(width, 8))

    # The JAX package on the same fleet (resumed from the port's dumps):
    # its served kernel in interpret mode on both schedules, the kernel's
    # chunk (the paired schedule's period) as interpret mode caps it
    # (``default_chunk``) and as the compiled kernel takes it
    # (``compiled_chunk``: the port's period), and its lanes engine in
    # float32 and float64.
    ref = ref_resume(port_dir)
    rrom = ref.rom
    # The fleet's combines are ordered by the port's dofs: where the JAX
    # package's greedy resumed another order (ties, degenerate spectra),
    # its reductors take the port's dofs.
    out["dofs_adopted_from_port"] = [
        n for n, (red, _fb) in rrom._theta_sources().items()
        if adopt_dofs(red, rom.reductors[n].dofs)]
    rrom.project_reductors()
    rrom.windows = rrom.mulocal.cells[CELL]
    rrom._windowed_pallas_tbl = None
    rrom._windowed_lanes_tbl = {}
    budget = type(rrom).ONLINE_PRECOMPUTE_BUDGET
    type(rrom).ONLINE_PRECOMPUTE_BUDGET = 0
    chunk_capped = po._chunk_capped
    served_ref = {}
    try:
        for chunk in ("default_chunk", "compiled_chunk"):
            po._chunk_capped = (
                chunk_capped if chunk == "default_chunk" else
                (lambda n, cap: period if (n, cap) == (width, 8)
                 else chunk_capped(n, cap)))
            for name, env in SCHEDULES.items():
                # The chunk is fixed when the kernel is traced.
                rrom._online_fns = {}
                jax.clear_caches()
                with _env(ROMTIME_SOLVE_ITERS="0", **env), \
                        ref_scope(jnp.float32):
                    t0 = time.perf_counter()
                    served_ref[f"{name}_{chunk}"] = np.asarray(
                        rrom.solve_batch(lanes, step=RefStage.ONLINE,
                                         mode="probes",
                                         engine="windowed-pallas")["probes"])
                    log("ref served", name, chunk,
                        f"{time.perf_counter() - t0:.1f} s")
    finally:
        po._chunk_capped = chunk_capped
        type(rrom).ONLINE_PRECOMPUTE_BUDGET = budget
    lanes_ref = {}
    for label, dtype in (("f32", jnp.float32), ("f64", jnp.float64)):
        rrom._online_fns = {}
        with ref_scope(dtype):
            t0 = time.perf_counter()
            lanes_ref[label] = np.asarray(rrom.solve_batch(
                lanes, step=RefStage.ONLINE, mode="probes",
                engine="windowed")["probes"])
            log("ref lanes", label, f"{time.perf_counter() - t0:.1f} s")

    # The JAX kernel against the port's twin on the port's captured
    # launch inputs, at the port's period.
    kernel_vs_twin = {}
    po._chunk_capped = lambda n, cap: period
    jax.clear_caches()
    try:
        for name, (a, kw) in captured.items():
            ref_kw = {k: v for k, v in kw.items() if k != "period"}
            t0 = time.perf_counter()
            P_ref = np.asarray(po.online_sweep_windowed_fused(
                *[jnp.asarray(t.numpy()) for t in a], **ref_kw,
                interpret=True)[0])
            t1 = time.perf_counter()
            if f"twin_{name}" not in port_res:
                port_res[f"twin_{name}"] = k1.windowed_fused_reference(
                    *a, **kw)[0].numpy()
                np.savez(cache, **port_res)
            P_twin = port_res[f"twin_{name}"]
            g = np.abs(P_ref[:, :2] - P_twin[:, :2])
            # (B, nt, 2), as the served probes.
            P_host = np.moveaxis(P_ref[:, :2], -1, 0)
            kernel_vs_twin[name] = dict(
                max=float(g.max()), scale=float(np.abs(P_ref[:, :2]).max()),
                kernel_seconds=t1 - t0,
                kernel_vs_ref_lanes_f64=gap(P_host, lanes_ref["f64"]),
                kernel_vs_ref_lanes_f32=gap(P_host, lanes_ref["f32"]))
            log("kernel vs twin", name, kernel_vs_twin[name])
    finally:
        po._chunk_capped = chunk_capped
        jax.clear_caches()

    served = {k[len("served_"):]: v for k, v in port_res.items()
              if k.startswith("served_")}
    scale = float(np.abs(lanes_ref["f64"]).max())
    gaps = {}
    for name in SCHEDULES:
        row = {}
        for chunk in ("default_chunk", "compiled_chunk"):
            P = served_ref[f"{name}_{chunk}"]
            row[f"ref_kernel_{chunk}_vs_ref_lanes_f64"] = gap(
                P, lanes_ref["f64"])
            row[f"ref_kernel_{chunk}_vs_ref_lanes_f32"] = gap(
                P, lanes_ref["f32"])
        P = served_ref[f"{name}_compiled_chunk"]
        row.update({
            "port_twin_vs_port_lanes_f64": gap(served[name],
                                               port_res["lanes_f64"]),
            "port_twin_vs_port_lanes_f32": gap(served[name],
                                               port_res["lanes_f32"]),
            "port_twin_vs_ref_kernel_compiled_chunk": gap(served[name], P),
            "port_twin_vs_ref_lanes_f64": gap(served[name], lanes_ref["f64"]),
        })
        gaps[name] = row
    gaps["lanes"] = {
        "ref_f32_vs_ref_f64": gap(lanes_ref["f32"], lanes_ref["f64"]),
        "port_f32_vs_port_f64": gap(port_res["lanes_f32"],
                                    port_res["lanes_f64"]),
        "port_f64_vs_ref_f64": gap(port_res["lanes_f64"], lanes_ref["f64"]),
        "port_f32_vs_ref_f32": gap(port_res["lanes_f32"], lanes_ref["f32"]),
    }
    for name, g in gaps.items():
        for k, v in g.items():
            log(f"{name} {k}: {v['max']:.3e} (steps {v['worst_steps']})")
    out.update(scale=scale, limit=5e-6 * scale, gaps=gaps,
               kernel_vs_twin=kernel_vs_twin)
    return out


# ----------------------------------------------------------------------
# Stage "f9": the two builds of the top cell, and the held-out μ
# ----------------------------------------------------------------------
def principal_sines(A, B):
    """sin of the largest principal angle between the spans of the
    orthonormal columns of A and B."""
    c = np.linalg.svd(np.asarray(A).T @ np.asarray(B), compute_uv=False)
    return float(np.sqrt(max(0.0, 1.0 - float(c.min()) ** 2)))


def ref_fom_references(fom, mus, dils):
    """The JAX package's float64 FOM trajectory (nt, nh) of each μ on
    its matched grid T·d (its ``_solve_registered_cell`` recipe)."""
    t_orig = fom.domain[fom.T]
    refs = []
    try:
        for m, d in zip(mus, dils):
            fom.domain[fom.T] = float(t_orig) * float(d)
            fom._solve_jit = {}
            fom.setup()
            fom.update_parametrization(m)
            fom.solve()
            refs.append(np.asarray(fom.solutions.fom, np.float64).T)
    finally:
        fom.domain[fom.T] = t_orig
        fom._solve_jit = {}
    return refs


def held_out_rel(label, hrom, mus, fom_refs, scope, dtype):
    """rel-L2 of each μ through the package's float64 windowed lanes
    engine (``mode="full"``) against its FOM on the matched grid."""
    rom = hrom.rom
    t0 = time.perf_counter()
    with scope(dtype):
        full = rom.solve_batch_mulocal(mus, mode="full", engine="windowed")
    dils = [float(d) for d in np.asarray(full["dil"], np.float64)]
    refs = fom_refs(hrom.fom, mus, dils)
    rels = [float(np.linalg.norm(np.asarray(full["uc"][i], np.float64)
                                 - refs[i]) / np.linalg.norm(refs[i]))
            for i in range(len(mus))]
    cells = rom.mulocal.cell_of([rom.compute_piston_mach_number(m)
                                 for m in mus])
    rows = [dict(mach=float(rom.compute_piston_mach_number(m)),
                 cell=int(c), dil=d, rel_l2=r)
            for m, c, d, r in zip(mus, cells, dils, rels)]
    log(label, "held-out", [(round(r["mach"], 4), r["cell"],
                             f"{r['rel_l2']:.4e}") for r in rows],
        f"{time.perf_counter() - t0:.1f} s")
    return rows


def f9_stage(port_dir, ref_dir, port32_dir=None):
    """F9 (module doc): cell 5 of the two builds, stage by stage, then
    the held-out μ of phase 12 (d) through each package."""
    import jax.numpy as jnp

    from romtime_tpu.dtypes import compute_dtype_scope as ref_scope
    from romtime_tpu_torch.dtypes import compute_dtype_scope
    from romtime_tpu_torch.problems import JOINT_CENTER_MU

    out = {}
    port = port_resume(port_dir)
    ref = ref_resume(ref_dir)
    prom, rrom = port.rom, ref.rom
    out["offline_mu_equal"] = (
        [{k: float(v) for k, v in m.items()}
         for m in port.mu_space["offline"]]
        == [{k: float(v) for k, v in m.items()}
            for m in ref.mu_space["offline"]])
    Vp, Vr = np.asarray(prom.basis), np.asarray(rrom.basis)
    half = Vp.shape[1] // 2
    out["global_basis"] = dict(
        N=[Vp.shape[1], Vr.shape[1]], sin_max_angle=principal_sines(Vp, Vr),
        sin_max_angle_leading_half=principal_sines(Vp[:, :half],
                                                   Vr[:, :half]))
    out["dofs_same_sets"] = {
        n: sorted(map(tuple, red.dofs))
        == sorted(map(tuple, rrom._theta_sources()[n][0].dofs))
        for n, red in prom.reductors.items()}
    pm, rm = port.cell_mus[CELL], ref.cell_mus[CELL]
    out["training_mu"] = dict(
        count=[len(pm), len(rm)],
        same_order=len(pm) == len(rm) and all(
            abs(a[k] - b[k]) <= 1e-12 * abs(b[k]) for a, b in zip(pm, rm)
            for k in b))
    cp, cr = prom.mulocal.cells[CELL], rrom.mulocal.cells[CELL]
    lp, lr = cp.dilation, cr.dilation
    out["law"] = dict(
        names=[list(lp.names), list(lr.names)],
        coef=[np.asarray(lp.coef).tolist(), np.asarray(lr.coef).tolist()],
        coef_max_rel_gap=float(np.max(np.abs(np.asarray(lp.coef)
                                             - np.asarray(lr.coef))
                                      / np.abs(np.asarray(lr.coef)))),
        training_d_max_gap=float(max(abs(float(lp.predict(m))
                                         - float(lr.predict(m)))
                                     for m in rm)))
    Wp, Wr = np.asarray(cp.Vs), np.asarray(cr.Vs)
    out["windows"] = dict(
        bounds_equal=bool(np.array_equal(cp.bounds, cr.bounds)))
    for k in (Wp.shape[2], Wp.shape[2] // 2):
        sines = [principal_sines(Wp[w][:, :k], Wr[w][:, :k])
                 for w in range(Wp.shape[0])]
        out["windows"][f"leading_{k}"] = dict(
            sin_max_angle_max=float(max(sines)),
            sin_max_angle_median=float(np.median(sines)),
            worst_window=int(np.argmax(sines)))
    log("f9 build", out)
    mus = [dict(JOINT_CENTER_MU)] + cs.held_out_mus(
        prom, cs.FLEET_BUILD_HELD_OUT)
    out["held_out_port"] = held_out_rel(
        "port", port, mus, cs.fom_references, compute_dtype_scope,
        torch.float64)
    out["held_out_ref"] = held_out_rel(
        "ref", ref, mus, ref_fom_references, ref_scope, jnp.float64)
    if port32_dir is not None and os.path.exists(port32_dir):
        p32 = port_resume(port32_dir)
        out["port_f32_training_mu_same"] = p32.cell_mus[CELL] == pm
        out["port_f32_law_coef"] = np.asarray(
            p32.rom.mulocal.cells[CELL].dilation.coef).tolist()
        out["held_out_port_f32_sweep"] = held_out_rel(
            "port (float32 training sweep)", p32, mus, cs.fom_references,
            compute_dtype_scope, torch.float64)
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workdir", default=os.path.join(
        REPO, "build", "cpu_fleet_parity"))
    parser.add_argument("--stages", default="port,port32,ref,serve,f9")
    parser.add_argument("--rebuild", default="")
    parser.add_argument("--lanes", type=int, default=N_LANES)
    parser.add_argument("--small", action="store_true")
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    stages = args.stages.split(",")
    if args.small:
        shrink()
    res = {"grid": GRID, "per_cell": PER_CELL, "register": REGISTER,
           "cell_wn": CELL_WN}
    port_dir = os.path.join(args.workdir, "port")
    if "port" in stages:
        if ("port" in args.rebuild
                or not os.path.exists(os.path.join(
                    port_dir, "windowed_serving_mulocal.npz"))):
            _h, res["port_build"] = port_build(port_dir)
        log("port stage done")
    if "port32" in stages:
        d32 = os.path.join(args.workdir, "port_f32")
        if ("port32" in args.rebuild or not os.path.exists(os.path.join(
                d32, "windowed_serving_mulocal.npz"))):
            _h, res["port_f32_build"] = port_build(d32, sweep_f32=True)
        log("port32 stage done")
    ref_dir = os.path.join(args.workdir, "ref")
    if "ref" in stages or "f9" in stages or "serve" in stages:
        jax_setup()
    if "ref" in stages:
        if ("ref" in args.rebuild
                or not os.path.exists(os.path.join(
                    ref_dir, "windowed_serving_mulocal.npz"))):
            _h, res["ref_build"] = ref_build(ref_dir)
        log("ref stage done")
    if "serve" in stages:
        res["serve"] = serve_stage(args.workdir, args.lanes)
        log("serve stage done")
    if "f9" in stages:
        res["f9"] = f9_stage(port_dir, ref_dir,
                             os.path.join(args.workdir, "port_f32"))
        log("f9 stage done")
    write(res, args.out or (os.path.join(args.workdir, "cpu_fleet_parity.json")
                            if args.small else OUT))


def write(res, path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    old = {}
    if os.path.exists(path):
        with open(path) as f:
            old = json.load(f)
    old.update(res)
    with open(path, "w") as f:
        json.dump(old, f, indent=1, default=float)
    log("wrote", path)


def shrink():
    global GRID, CELL_WN, PER_CELL
    GRID = {"nx": 100, "nt": 60, "tf": 1.0}
    CELL_WN = ((2, 10),) * 4 + ((2, 12),) * 2
    PER_CELL = (2, 2, 2, 2, 2, 6)
    cs.FLEET_PROBE_EXTRA = 4


if __name__ == "__main__":
    with torch.inference_mode():
        main()
