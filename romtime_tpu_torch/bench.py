"""The bench entry: build (or resume), certify and time the piston ROM on
the card and print one JSON line (counterpart of the JAX repository's
``bench.py``).

    python -m romtime_tpu_torch.bench

Pipeline (the moving-piston problem at nx=1000, nt=1500 unless
``BENCH_NX``/``BENCH_NT`` say otherwise):

- **offline**: the float64 FOM sweep, POD, (M)DEIM training and
  projection, then the windowed serving and, in the "joint" profile, the
  μ-local fleet of six Mach cells (:func:`build`, ``bench.py:195-439``);
  or a warm resume of the working directory's artifacts
  (``start_from_existing_basis``) when ``basis_srom.pkl`` is there and
  ``BENCH_COLD`` is not 1;
- **accuracy**: the center μ's float64 trajectory against the float64 FOM
  on its matched grid, the held-out μ and the S-ROM estimator
  (:func:`fleet_certification`, :func:`global_certification`,
  ``bench.py:442-705``), the served batch's probes against the float64
  lanes engine and the float32 drift (``:961-995``);
- **online**: the served call (θ prep and the kernel: K1 for the
  windowed fleet's active cell, K4 or K5 for the global profile) timed
  by ``bench.py``'s chained marginal (``:706-874``), the
  fetch-inclusive variant, and the routed six-cell fleet call beside it
  (logged to stderr); then K1's cost ledger at the served solve
  (``kernel_ledger.kernel_ledger``, ``:873-959``).

Prints ``bench.py``'s payload (``:997-1042``) as the last line of
standard output, with one added key, ``extra.device``: the card's name
and power limit as ``nvidia-smi`` gives them. ``vs_baseline`` is the
solves/s over the JAX repository's 10,000 solves/s TPU north star,
printed for the payload's shape only: it is no target of the port.
Progress goes to standard error (``BENCH_QUIET=1`` silences it).

Knobs, as ``bench.py`` reads them: ``BENCH_PROFILE`` (``joint``, else
the throughput profile), ``BENCH_NX``, ``BENCH_NT``,
``BENCH_OFFLINE_MU``, ``BENCH_ONLINE_MU``, ``BENCH_SROM_MODES``,
``BENCH_SROM_TRUNCATE``, ``BENCH_WINDOWS``, ``BENCH_WINDOW_N``,
``BENCH_NMDEIM``, ``BENCH_COLD``, ``BENCH_OFFLINE`` (``cpu``: every FOM
solve float64 on the host's native loop; ``device``/``device-dd``: each
sweep one batch on the card, ``device_sweep``: the global one in float64,
as every offline step of the port runs, the fleet's training sweep in
float32, compensated under ``device-dd``), ``BENCH_WINDOW_SROM_EXTRA``,
``BENCH_MULOCAL``, ``BENCH_CELL_WN`` (a list of ``WxN`` or ``auto``),
``BENCH_FLEET_CANDIDATES``, ``BENCH_FLEET_TARGET``,
``BENCH_MULOCAL_EDGES``, ``BENCH_REGISTER``, ``BENCH_PER_CELL``,
``BENCH_MULTI_MU``, ``BENCH_F32``, ``BENCH_PRECOMPUTE_BUDGET_GB``,
``BENCH_REPEAT``, ``BENCH_MODE``, ``BENCH_ENGINE``, ``BENCH_AUTOTUNE``,
``BENCH_PROBE_REDUCE``, ``BENCH_LEDGER``, ``BENCH_DIR`` (the working
directory: default ``.bench_torch/`` beside the package, ``tmp`` a
throwaway one) and the solve policy's ``ROMTIME_SOLVE_ITERS``,
``ROMTIME_PAIRED_LU`` and ``ROMTIME_PAIRED_MODE`` (read from the
process environment). ``BENCH_CACHE`` and ``JAX_PLATFORMS`` configure
JAX and have no counterpart here. One knob is the port's own:
``BENCH_DEVICE`` (default ``cuda``); ``cpu`` is the only way onto the
host, and without a card the entry raises.

Each timed chain ends in one ``torch.cuda.synchronize()``; the chain's
arithmetic (each call's first μ component perturbed by the previous
call's ``uN_final`` sum times 1e-30 plus k·1e-9, the marginal of
``BENCH_REPEAT`` calls against one, the 5% guard) is the reference's.

:func:`run` returns the payload; :func:`build` and :func:`measure` are
its two halves, which ``chip_smoke.py`` calls on the ROMs it builds.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from .conventions import Errors, PistonParameters, Stage, StorageNames
from .dtypes import compute_dtype_scope

#: The JAX repository's TPU north star (solves/s), the denominator of
#: ``vs_baseline``.
BASELINE_SOLVES_PER_SEC = 10000.0
#: bench.py's timed batch: the Mach-stratified draws of this many bins
#: (RandomState(3)) tiled to the batch (bench.py:709-716).
TIMED_SPACE = 64
#: bench.py's held-out μ: the draws of 16 Mach bins with RandomState(7)
#: (15: the top bin lies above the box's largest Mach; bench.py:513-521),
#: and the first rows of the timed batch held against the float64 lanes
#: engine (bench.py:969).
FLEET_CERT_BINS = 16
FLEET_CERT_PROBE_ROWS = 16
F32_DRIFT_MAX = 1e-5      # a guard: a float32 solve that left float64
#: The flagship fleet's limits, each tighter than BENCH_r05.json's figure
#: needs: the center, the held-out maxima on the matched grid and on the
#: standard clock (BASELINE.md:29), the estimator/true ratio range, the
#: served engine's probe error and the float32 drift.
FLEET_CERT_LIMITS = {"rel_l2_vs_fom": 3e-7, "multi_max": 1e-6,
                     "std_max": 1e-6, "ratio_min": 0.9, "ratio_max": 1.1,
                     "served_engine_probe_err": 1e-5,
                     "f32_serving_drift": F32_DRIFT_MAX}
#: The reference's figures for the same numbers (BENCH_r05.json: the JAX
#: package on a TPU, the joint profile, the same fleet), printed beside.
BENCH_R05 = {"rel_l2_vs_fom": 2.5268368645023236e-07,
             "multi_max": 9.70009189913143e-07,
             "std_max": 9.838497337794282e-07,
             "ratio_min": 0.9188733229789863,
             "ratio_max": 1.0392924618642259,
             "served_engine_probe_err": 5.127823107266107e-06,
             "f32_serving_drift": 8.879870612308402e-07,
             "fom_dt_gap_max": 0.0008955800357241662,
             "registered_cells": [0, 1, 2, 3, 4, 5]}
#: bench.py's profile defaults (bench.py:111-119).
PROFILES = {
    "joint": dict(modes=96, truncate=8, nmdeim=96, windows=50, window_n=32,
                  batch=2048, offline_mu=8, tri_mu=3, mulocal=6,
                  per_cell="12,12,12,12,16,24", register="auto",
                  cell_wn="50x32,50x32,50x32,50x32,150x48,150x48"),
    "throughput": dict(modes=20, truncate=5, nmdeim=12, windows=0,
                       window_n=0, batch=2048, offline_mu=3, tri_mu=2,
                       mulocal=0, per_cell=0),
}
#: The payload's keys and those of its ``extra`` (bench.py:997-1042),
#: the port's ``device`` beside them.
PAYLOAD_KEYS = ("metric", "value", "unit", "vs_baseline", "rel_l2_vs_fom",
                "offline_wall_s", "extra")
EXTRA_KEYS = (
    "backend", "profile", "n_windows", "window_n", "cell_wn",
    "registered_cells", "nx", "nt", "rom_modes", "batch", "mode", "engine",
    "offline_build", "solve_iters", "host_fetch_wall_s", "fetch_inclusive",
    "single_sweep_plus_sync_wall_s", "online_sweep_wall_s",
    "offline_wall_s", "rel_l2_vs_fom", "f32_serving_drift",
    "timesteps_per_sec", "served_engine_probe_err", "kernel_ledger",
    "rel_l2_multi_mu", "rel_l2_multi_mu_std", "windowed_estimator",
    "precompute_autotune", "device")
#: The FOM reference caches (bench.py:484, :545, :619), in the working
#: directory.
FOM_CACHE = "fom_validation.npz"
FOM_CACHE_MULTI = "fom_validation_multi.npz"
FOM_CACHE_STD = "fom_validation_multi_std.npz"

_T0 = time.time()


def log(msg):
    if os.environ.get("BENCH_QUIET", "0") != "1":
        print(f"[bench +{time.time() - _T0:8.1f}s] {msg}", file=sys.stderr,
              flush=True)


def settings(env=None):
    """bench.py's knobs from ``env`` (default ``os.environ``), parsed."""
    env = os.environ if env is None else env
    profile = env.get("BENCH_PROFILE", "joint")
    d = PROFILES["joint" if profile == "joint" else "throughput"]

    def num(name, default, kind=int):
        return kind(env.get(name, default))

    return dict(
        profile=profile, nx=num("BENCH_NX", 1000), nt=num("BENCH_NT", 1500),
        n_offline=num("BENCH_OFFLINE_MU", d["offline_mu"]),
        n_online=num("BENCH_ONLINE_MU", d["batch"]),
        modes=num("BENCH_SROM_MODES", d["modes"]),
        truncate=num("BENCH_SROM_TRUNCATE", d["truncate"]),
        n_windows=num("BENCH_WINDOWS", d["windows"]),
        window_n=num("BENCH_WINDOW_N", d["window_n"]),
        nmdeim=num("BENCH_NMDEIM", d["nmdeim"]), tri_mu=d["tri_mu"],
        cold=env.get("BENCH_COLD", "0") == "1",
        offline=env.get("BENCH_OFFLINE", "cpu"),
        srom_extra=num("BENCH_WINDOW_SROM_EXTRA", 8),
        n_cells=num("BENCH_MULOCAL", d["mulocal"]),
        cell_wn=env.get("BENCH_CELL_WN", d.get("cell_wn")),
        candidates=env.get("BENCH_FLEET_CANDIDATES", "50x32,30x40"),
        target=num("BENCH_FLEET_TARGET", "1e-5", float),
        edges=env.get("BENCH_MULOCAL_EDGES"),
        register=env.get("BENCH_REGISTER", d.get("register", "")),
        per_cell=str(env.get("BENCH_PER_CELL", d["per_cell"])),
        n_multi=num("BENCH_MULTI_MU", 16),
        f32=env.get("BENCH_F32", "1") == "1",
        budget_gb=env.get("BENCH_PRECOMPUTE_BUDGET_GB"),
        n_rep=num("BENCH_REPEAT", 3),
        mode=env.get("BENCH_MODE", "probes"),
        engine=env.get("BENCH_ENGINE") or None,
        autotune=env.get("BENCH_AUTOTUNE", "0") == "1",
        probe_reduce=env.get("BENCH_PROBE_REDUCE", "mean"),
        ledger=env.get("BENCH_LEDGER", "1") == "1",
        device=env.get("BENCH_DEVICE", "cuda"))


def resolve_device(device):
    """``device`` as a :class:`torch.device`; raises where it names the
    card and there is none: nothing falls back to the host."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the bench entry runs on the card "
                           "(BENCH_DEVICE=cpu runs it on the host)")
    return device


def card_line(device):
    """``nvidia-smi``'s name and power limit of the card, or the device's
    name off the card."""
    if device.type != "cuda":
        return str(device)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(dev, fn):
    """(fn(), seconds), a CUDA device synchronized on both sides."""
    dev = torch.device(dev)
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def _shapes(spec):
    return [tuple(int(v) for v in s.split("x")) for s in spec.split(",")]


# ----------------------------------------------------------------------
# Offline: build or resume (bench.py:195-439)
# ----------------------------------------------------------------------
def build(cfg, device):
    """bench.py's offline half in the working directory, on ``device``:
    the global build (or its warm resume), the windowed serving and the
    μ-local fleet the knobs ask for, the active cell (the center μ's Mach
    cell, bench.py:428-438) attached as the serving windows. Returns
    (hrom, info) with ``info`` = {offline_wall, warm, n_windows,
    window_n, active}."""
    from .problems import JOINT_CENTER_MU, piston_profile
    from .rom.hrom import HyperReducedPiston

    t_start = time.time()
    warm = os.path.exists(StorageNames.SROM) and not cfg["cold"]
    hrom = HyperReducedPiston(**piston_profile(
        nx=cfg["nx"], nt=cfg["nt"], tf=1.0, n_offline=cfg["n_offline"],
        modes=cfg["modes"], truncate=cfg["truncate"], nmdeim=cfg["nmdeim"],
        tri_mu=cfg["tri_mu"], device=str(device)))
    offline = cfg["offline"]
    device_sweep = offline in ("device", "device-dd")
    log("offline: setup")
    hrom.setup()
    hrom.setup_hyperreduction()
    if warm:
        log("offline: WARM resume from existing artifacts")
        hrom.start_from_existing_basis()
        hrom.project_reductors()
    else:
        log(f"offline: FOM sweep + POD ({offline})")
        if device_sweep:
            hrom.fom.dd_sweep = offline == "device-dd"
            with compute_dtype_scope(torch.float32):
                hrom.run_offline_rom(device_sweep=True)
            hrom.fom.dd_sweep = False
        else:
            hrom.run_offline_rom()
        log("offline: (M)DEIM training")
        hrom.run_offline_hyperreduction(
            mu_space=hrom.mu_space[Stage.OFFLINE], evaluate=False)
        log("offline: projection")
        hrom.project_reductors()
        hrom.dump_mu_space()
        hrom.dump_reduced_basis()
        hrom.dump_offline_snapshots()

    rom = hrom.rom
    srom_extra = cfg["srom_extra"]
    n_windows, window_n = cfg["n_windows"], cfg["window_n"]
    if n_windows > 0:
        win = rom.windows
        if win is not None and (win.n_windows != n_windows
                                or win.N != window_n):
            rom._set_serving_windows(None)
            win = None
        if win is None:
            log(f"offline: windowed serving build (W={n_windows}, "
                f"N={window_n}/window)")
            hrom.build_windowed_serving(n_windows=n_windows,
                                        num_basis=window_n,
                                        srom_extra=srom_extra or None)
        elif (srom_extra and (hrom.windows_srom is None
                              or hrom.windows_srom.n_windows != n_windows
                              or hrom.windows_srom.N
                              != window_n + srom_extra)
              and hrom.srom.offline_snapshots):
            log("offline: sacrificial windowed build (estimator reference)")
            hrom.build_windowed_srom(n_windows=n_windows,
                                     num_basis=window_n + srom_extra)

    n_cells = cfg["n_cells"]
    spec = cfg["cell_wn"]
    auto_fleet = spec == "auto"
    cell_wn = _shapes(spec) if spec and not auto_fleet else None
    edges = ([float(x) for x in cfg["edges"].split(",")]
             if cfg["edges"] else None)

    def resolve_auto_fleet():
        wn, floors = hrom.auto_cell_wn(_shapes(cfg["candidates"]),
                                       cfg["target"],
                                       expect_n_cells=n_cells,
                                       expect_edges=edges)
        log(f"offline: auto fleet {wn} (predicted projection floors "
            + str(["%.2e" % f for f in floors]) + ")")
        return [tuple(w) for w in wn]

    active = None
    if n_cells > 0 and n_windows > 0:
        reg = cfg["register"]
        if reg == "top":
            register = [n_cells - 1]
        elif reg in ("all", "auto"):
            register = reg
        elif reg:
            register = [int(x) for x in reg.split(",")]
        else:
            register = None
        if auto_fleet and os.path.exists(StorageNames.MULOCAL_SNAPSHOTS):
            cell_wn = resolve_auto_fleet()
        want_wn = cell_wn or [(n_windows, window_n)] * n_cells
        ml = rom.mulocal
        have_reg = (set() if ml is None else
                    {c for c, w in enumerate(ml.cells)
                     if w.dilation is not None})
        if register in ("all", "auto"):
            reg_mismatch = not have_reg
        else:
            reg_mismatch = have_reg != set(register or [])
        per_cell = cfg["per_cell"]
        kwargs = dict(
            n_cells=n_cells, n_windows=n_windows, num_basis=window_n,
            snapshots_per_cell=([int(x) for x in per_cell.split(",")]
                                if "," in per_cell else int(per_cell)),
            srom_extra=srom_extra or None, edges=edges, cell_wn=cell_wn,
            register=register, device_sweep=device_sweep)

        def build_fleet():
            hrom.fom.dd_sweep = offline == "device-dd"
            try:
                return hrom.build_mulocal_serving(**kwargs)
            finally:
                hrom.fom.dd_sweep = False

        if (ml is None or ml.n_cells != n_cells
                or ml.cell_wn != [tuple(x) for x in want_wn] or reg_mismatch
                or (srom_extra and ml.cells_srom is None)):
            log(f"offline: mu-local serving build (K={n_cells} Mach cells"
                + (", device sweep" if device_sweep else "") + ")")
            ml = build_fleet()
            if auto_fleet and cell_wn is None:
                cell_wn = resolve_auto_fleet()
                if ml.cell_wn != cell_wn:
                    kwargs["cell_wn"] = cell_wn
                    ml = build_fleet()
        elif auto_fleet and cell_wn is None:
            log("offline: BENCH_CELL_WN=auto requested but no snapshot "
                "cache exists and the resumed fleet already matches the "
                "uniform shape — serving the uniform fleet (delete "
                "BENCH_DIR artifacts or run BENCH_COLD=1 to produce the "
                "cache for auto selection)")
        active = int(ml.cell_of(rom.compute_piston_mach_number(
            JOINT_CENTER_MU)))
        rom._set_serving_windows(ml.cells[active])
        log(f"offline: active serving cell {active} (edges "
            f"{np.round(ml.edges, 3).tolist()}, fleet {ml.cell_wn})")
        n_windows, window_n = ml.cell_wn[active]
    return hrom, dict(offline_wall=time.time() - t_start, warm=warm,
                      n_windows=n_windows, window_n=window_n, active=active)


# ----------------------------------------------------------------------
# Accuracy: the certification (bench.py:442-705, :961-995)
# ----------------------------------------------------------------------
def bench_mus(rom, bins, seed, B=None):
    """bench.py's Mach-stratified μ (``build_sampling_space(bins,
    RandomState(seed))``, bench.py:518-521, :709-716): one draw a Mach bin
    (the bins above the box's largest Mach stay empty), sorted by Mach,
    the Mach tag dropped; tiled to ``B`` where given."""
    mus = [{k: float(v) for k, v in m.items()
            if k != PistonParameters.MACH_PISTON}
           for m in rom.build_sampling_space(
               num=bins, rnd=np.random.RandomState(seed))]
    if B is None:
        return mus
    return (mus * -(-B // len(mus)))[:B]


def fom_references(fom, mus, dils):
    """Each μ's float64 FOM trajectory (uc, (nt, nh)) on its matched grid
    (T·d, the same nt steps), in one ``solve_fom_batch`` on the FOM's
    device with per-lane clocks."""
    from .parallel import solve_fom_batch

    if not mus:
        return []
    with compute_dtype_scope(torch.float64):
        return list(solve_fom_batch(fom, mus, dilations=dils)["uc"])


def fom_reference(fom, mu, d=1.0):
    """bench.py:451-469's FOM reference, (nh, nt): a float64 ``fom.solve()``
    on the grid T·d (the same nt steps)."""
    t_orig = fom.domain[fom.T]
    try:
        fom.domain[fom.T] = float(t_orig) * float(d)
        with compute_dtype_scope(torch.float64):
            fom.setup()
            fom.update_parametrization(dict(mu))
            fom.solve()
        return np.asarray(fom.solutions.fom, np.float64)
    finally:
        fom.domain[fom.T] = t_orig


def _mu_key(mus):
    return np.array([[float(m[k]) for k in sorted(m)] for m in mus])


def read_fom_cache(path, fom, mus, **match):
    """The (B, nh, nt) trajectories of a FOM reference cache (bench.py
    :484-494, :545-558, :619-629) when it holds this grid, the μ ``mus``
    and ``match`` (``dil``: the dilations, 1 where the file has none;
    ``idx``: the indices of the μ it holds), else None."""
    if path is None or not os.path.exists(path):
        return None
    key = _mu_key(mus)
    with np.load(path) as d:
        mu = np.asarray(d["mu"], np.float64)
        if (int(d["nx"]) != int(fom.domain[fom.NX])
                or int(d["nt"]) != int(fom.domain[fom.NT])
                or mu.size != key.size
                or not np.allclose(mu.reshape(key.shape), key)):
            return None
        if "dil" in match:
            want = np.asarray(match["dil"], np.float64).reshape(-1)
            got = (np.asarray(d["dil"], np.float64).reshape(-1)
                   if "dil" in d else np.ones_like(want))
            if got.shape != want.shape or not np.allclose(got, want):
                return None
        if "idx" in match and not np.array_equal(d["idx"], match["idx"]):
            return None
        uh = np.asarray(d["uh"], np.float64)
    return uh.reshape((-1,) + uh.shape[-2:])


def write_fom_cache(path, fom, mus, uh, single=False, **extra):
    """A FOM reference cache in bench.py's layout: ``uh`` (B, nh, nt),
    ``nx``, ``nt``, ``mu`` (the values of ``mus`` by sorted name) and
    ``extra``; ``single``: one μ, ``uh`` (nh, nt) and ``mu`` a row, as
    bench.py writes ``fom_validation.npz``."""
    if path is None:
        return
    uh, key = np.asarray(uh), _mu_key(mus)
    if single:
        uh, key = uh[0], key[0]
    np.savez(path, uh=uh, nx=int(fom.domain[fom.NX]),
             nt=int(fom.domain[fom.NT]), mu=key, **extra)


def _cached_references(fom, groups, cache_dir):
    """Each group's float64 FOM trajectories ((nt, nh) each): from its
    cache in ``cache_dir`` where that holds them, the rest in one
    :func:`fom_references` batch, each such group then written to its
    cache. ``groups``: (file, the μ its cache is keyed by, the μ to solve,
    their dilations, ``match`` as :func:`read_fom_cache` takes it, the
    cache's other keys)."""
    found, todo = [], []
    for name, key_mus, mus, dils, match, extra in groups:
        path = None if cache_dir is None else os.path.join(cache_dir, name)
        got = read_fom_cache(path, fom, key_mus, **match) if mus else []
        if got is not None:
            if len(mus):
                log(f"accuracy: {len(mus)} FOM reference(s) ({name}, "
                    f"cached)")
            found.append([np.ascontiguousarray(u.T) for u in got])
        else:
            found.append(None)
            todo.append((len(found) - 1, path, key_mus, mus, dils, extra))
    refs = fom_references(fom, [m for *_a, mus, _d, _e in todo for m in mus],
                          [d for *_a, dils, _e in todo for d in dils])
    at = 0
    for i, path, key_mus, mus, _dils, extra in todo:
        found[i] = refs[at:at + len(mus)]
        at += len(mus)
        write_fom_cache(path, fom, key_mus, np.stack([u.T for u in found[i]]),
                        single=path is not None
                        and os.path.basename(path) == FOM_CACHE, **extra)
    return found


def fleet_certification(hrom, timed_mus, timed_probes,
                        n_multi=FLEET_CERT_BINS, cache_dir=None):
    """bench.py's certification of the windowed ROM (bench.py:442-705,
    :963-995), through the port's own calls on the device ``hrom`` serves
    on. With a μ-local fleet the active cell (the center's Mach cell,
    bench.py:431-432) is on the ROM while it runs and the serving windows
    restored after:

    - the center μ through ``solve_batch(mode="full", engine="windowed")``
      in float64 against the float64 FOM on its matched grid (T·d);
    - bench's ``n_multi``-bin held-out μ (:func:`bench_mus`) routed
      through ``solve_batch_mulocal(mode="full", engine="windowed")`` (the
      windows' own ``solve_batch`` without a fleet) in float64, each
      against the FOM on its lane's matched grid; on the registered lanes
      both trajectories mapped to the standard clock by
      ``resample_to_standard``, and the mapped FOM against a true
      standard-grid FOM (the dt-gap); every FOM reference that its cache
      in ``cache_dir`` (:data:`FOM_CACHE`, :data:`FOM_CACHE_MULTI`,
      :data:`FOM_CACHE_STD`; None: no cache) does not hold in one
      ``solve_fom_batch`` with per-lane clocks;
    - ``estimate_batch_mulocal`` (``estimate_batch(engine="windowed")``
      without a fleet, where the S-ROM windows exist) in float64 on the
      same μ: each μ's ratio of the time-RMS estimator to the true
      time-RMS error;
    - the served batch's first FLEET_CERT_PROBE_ROWS probe rows
      (``timed_probes``, the (nt, 2, B) output of ``solve_batch(timed_mus,
      mode="probes", host=False)``; None: not certified) against the
      float64 lanes engine on the same μ, over the latter's scale;
    - the float32 drift of the center μ's lanes solve, over the FOM's
      norm.

    Returns a dict under bench.py's keys (``rel_l2_vs_fom``,
    ``rel_l2_multi_mu`` with ``std``, ``rel_l2_multi_mu_std``,
    ``windowed_estimator``, ``served_engine_probe_err``,
    ``f32_serving_drift``; None where ``n_multi`` is 0) plus each
    held-out μ's row, the active cell and the seconds of each step; and
    the estimator's output (or None)."""
    from .problems import JOINT_CENTER_MU
    from .rom.registration import resample_to_standard

    rom, fom, ml = hrom.rom, hrom.fom, hrom.rom.mulocal
    dev = rom.device
    mu_val = dict(JOINT_CENTER_MU)
    mus_val = bench_mus(rom, n_multi, 7)[:n_multi] if n_multi > 0 else []
    n = len(mus_val)
    active = (None if ml is None else
              int(ml.cell_of(rom.compute_piston_mach_number(mu_val))))
    prev = rom.windows
    secs = {}
    est = ref = None
    n_chk = min(FLEET_CERT_PROBE_ROWS, len(timed_mus))
    if active is not None:
        rom._set_serving_windows(ml.cells[active])
    try:
        with compute_dtype_scope(torch.float64):
            outs_v, secs["center_lanes"] = timed(dev, lambda: rom.solve_batch(
                [dict(mu_val)], mode="full", engine="windowed"))
            if n:
                route = (rom.solve_batch if ml is None
                         else rom.solve_batch_mulocal)
                outs_m, secs["held_out_lanes"] = timed(dev, lambda: route(
                    [dict(m) for m in mus_val], mode="full",
                    engine="windowed"))
                if ml is not None and ml.cells_srom is not None:
                    est, secs["estimator"] = timed(
                        dev, lambda: hrom.estimate_batch_mulocal(
                            [dict(m) for m in mus_val]))
                elif hrom.windows_srom is not None:
                    est, secs["estimator"] = timed(
                        dev, lambda: hrom.estimate_batch(
                            [dict(m) for m in mus_val], engine="windowed"))
            if timed_probes is not None:
                ref, secs["probe_lanes"] = timed(dev, lambda: rom.solve_batch(
                    [dict(m) for m in timed_mus[:n_chk]], mode="probes",
                    engine="windowed"))
        with compute_dtype_scope(torch.float32):
            outs32, secs["f32_lanes"] = timed(dev, lambda: rom.solve_batch(
                [dict(mu_val)], mode="full", engine="windowed"))
    finally:
        rom._set_serving_windows(prev)
    uh_rom = np.asarray(outs_v["uc"][0], np.float64)
    dil_val = float(np.asarray(outs_v.get("dil", [1.0]))[0])
    dils_m = (np.asarray(outs_m.get("dil", np.ones(n)), np.float64) if n
              else np.ones(0))
    reg_idx = [i for i in range(n) if dils_m[i] != 1.0]
    reg_mus = [mus_val[i] for i in reg_idx]
    (center, fom_refs, fom_std), secs["fom_references"] = timed(
        dev, lambda: _cached_references(fom, [
            (FOM_CACHE, [mu_val], [mu_val], [dil_val], {"dil": [dil_val]},
             {"dil": dil_val}),
            (FOM_CACHE_MULTI, mus_val, mus_val, dils_m.tolist(),
             {"dil": dils_m}, {"dil": dils_m}),
            (FOM_CACHE_STD, mus_val, reg_mus, [1.0] * len(reg_idx),
             {"idx": np.asarray(reg_idx)}, {"idx": np.asarray(reg_idx)})],
            cache_dir))
    uh_fom = center[0]

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    multi = rows = None
    rels_std, dt_gaps, ratios = {}, {}, []
    if n:
        uc = [np.asarray(outs_m["uc"][i], np.float64) for i in range(n)]
        rels = [rel(uc[i], fom_refs[i]) for i in range(n)]
        multi = {"n": n, "mean": float(np.mean(rels)),
                 "max": float(np.max(rels)),
                 "n_registered": len(reg_idx),
                 "dil_max": float(np.max(dils_m)),
                 "n_dil_flagged": (int(np.sum(np.asarray(
                     outs_m["dil_oor"], np.float64) > 0.5))
                     if "dil_oor" in outs_m else None)}
        for j, i in enumerate(reg_idx):
            ref_std = resample_to_standard(fom_refs[i], dils_m[i], axis=0)
            rels_std[i] = rel(resample_to_standard(uc[i], dils_m[i], axis=0),
                              ref_std)
            dt_gaps[i] = rel(ref_std, fom_std[j])
        if reg_idx:
            multi["std"] = {
                "n": len(reg_idx),
                "mean": float(np.mean(list(rels_std.values()))),
                "max": float(np.max(list(rels_std.values()))),
                "fom_dt_gap_mean": float(np.mean(list(dt_gaps.values()))),
                "fom_dt_gap_max": float(np.max(list(dt_gaps.values())))}
        if est is not None:
            e = np.asarray(est[Errors.ESTIMATOR], np.float64)
            for i in range(n):
                true_rms = (np.linalg.norm(uc[i] - fom_refs[i])
                            / np.sqrt(uc[i].size))
                ratios.append(float(np.sqrt(np.mean(e[i] ** 2)))
                              / max(true_rms, 1e-300))
        cells = (ml.cell_of([rom.compute_piston_mach_number(m)
                             for m in mus_val]) if ml is not None
                 else np.zeros(n, int))
        rows = [dict(mach=rom.compute_piston_mach_number(m), cell=int(c),
                     dil=float(d), rel_l2=r, rel_l2_std=rels_std.get(i),
                     fom_dt_gap=dt_gaps.get(i),
                     ratio=ratios[i] if ratios else None)
                for i, (m, c, d, r) in enumerate(
                    zip(mus_val, cells, dils_m, rels))]
    probe_err = None
    if ref is not None:
        p_ref = np.asarray(ref["probes"], np.float64)
        p_timed = np.moveaxis(torch.as_tensor(timed_probes).detach().cpu()
                              .numpy(), -1, 0)[:n_chk].astype(np.float64)
        scale = max(float(np.abs(p_ref).max()), 1e-12)
        probe_err = float(np.abs(p_timed - p_ref).max() / scale)
    cert = {
        "rel_l2_vs_fom": rel(uh_rom, uh_fom),
        "rel_l2_multi_mu": multi,
        "rel_l2_multi_mu_std": None if multi is None else multi.get("std"),
        "windowed_estimator": None if not ratios else {
            "avg_estimator_mean": float(np.mean(
                est[Errors.AVERAGE_ESTIMATOR])),
            "ratio_min": float(np.min(ratios)),
            "ratio_max": float(np.max(ratios))},
        "served_engine_probe_err": probe_err,
        "f32_serving_drift": float(np.linalg.norm(
            np.asarray(outs32["uc"][0], np.float64) - uh_rom)
            / np.linalg.norm(uh_fom)),
        "active_cell": active, "center_dil": dil_val, "rows": rows or [],
        "seconds": secs}
    return cert, est


def global_certification(hrom, serve_dtype=torch.float32, cache_dir=None):
    """bench.py's certification of the global ROM (bench.py:479-505,
    :982-995): the center μ's float64 ``rom.solve`` against the float64
    FOM (a ``fom.solve()``, cached in :data:`FOM_CACHE`), and the drift of
    the ``serve_dtype`` solve over the FOM's norm. Returns the dict of
    :func:`fleet_certification`'s keys, None where they need windows. The
    solves record the center under the online stage (bench.py: the
    validation stage), so that the driver's ``evaluate_validation``
    still indexes its own build's trajectories."""
    from .problems import JOINT_CENTER_MU

    rom, fom = hrom.rom, hrom.fom
    mu_val = dict(JOINT_CENTER_MU)
    secs = {}
    with compute_dtype_scope(torch.float64):
        _, secs["center_solve"] = timed(rom.device, lambda: rom.solve(
            mu=dict(mu_val), step=Stage.ONLINE))
    uh_rom = np.asarray(rom.solutions.fom, np.float64)
    path = None if cache_dir is None else os.path.join(cache_dir, FOM_CACHE)
    cached = read_fom_cache(path, fom, [mu_val], dil=[1.0])
    if cached is not None:
        log("accuracy: FOM reference solve (cached)")
        uh_fom = cached[0]
    else:
        log("accuracy: FOM reference solve")
        uh_fom, secs["fom_reference"] = timed(
            rom.device, lambda: fom_reference(fom, mu_val))
        write_fom_cache(path, fom, [mu_val], uh_fom[None], single=True,
                        dil=1.0)
    with compute_dtype_scope(serve_dtype):
        _, secs["serve_dtype_solve"] = timed(rom.device, lambda: rom.solve(
            mu=dict(mu_val), step=Stage.ONLINE))
    uh32 = np.asarray(rom.solutions.fom, np.float64)
    norm = np.linalg.norm(uh_fom)
    return {"rel_l2_vs_fom": float(np.linalg.norm(uh_rom - uh_fom) / norm),
            "rel_l2_multi_mu": None, "rel_l2_multi_mu_std": None,
            "windowed_estimator": None, "served_engine_probe_err": None,
            "f32_serving_drift": float(np.linalg.norm(uh32 - uh_rom) / norm),
            "active_cell": None, "rows": [], "seconds": secs}


def certified_numbers(cert):
    """name → value of the numbers FLEET_CERT_LIMITS holds."""
    multi = cert["rel_l2_multi_mu"]
    std = multi.get("std") or {}
    return {"rel_l2_vs_fom": cert["rel_l2_vs_fom"],
            "multi_max": multi["max"], "std_max": std.get("max"),
            "ratio_min": cert["windowed_estimator"]["ratio_min"],
            "ratio_max": cert["windowed_estimator"]["ratio_max"],
            "served_engine_probe_err": cert["served_engine_probe_err"],
            "f32_serving_drift": cert["f32_serving_drift"]}


def hold_certification(cert, power, limits=None):
    """Each certified number printed beside its limit (``limits``,
    default FLEET_CERT_LIMITS: a ``ratio_min`` from below, every other an
    upper bound), BENCH_r05.json's figure and the card; raises
    AssertionError naming every miss. A standard-clock maximum without a
    registered lane is a miss."""
    limits = FLEET_CERT_LIMITS if limits is None else limits
    misses = []
    for name, value in certified_numbers(cert).items():
        limit = limits[name]
        ok = value is not None and (value >= limit if name == "ratio_min"
                                    else value <= limit)
        print(f"    {name} {value if value is None else f'{value:.4e}'} "
              f"({'≥' if name == 'ratio_min' else '≤'} {limit:g}; "
              f"BENCH_r05 {BENCH_R05[name]:.4e}) on {power} "
              f"{'ok' if ok else 'MISS'}")
        if not ok:
            misses.append(f"{name} {value} (limit {limit})")
    if misses:
        raise AssertionError("the fleet misses the certification bar: "
                             + "; ".join(misses))


# ----------------------------------------------------------------------
# Online: the served call, timed (bench.py:706-874)
# ----------------------------------------------------------------------
def marginal(run_chain, n_rep):
    """bench.py's chained marginal: (wall of one call, per-call wall)
    from a chain of one and a chain of ``n_rep`` (each run once to warm
    up first), falling back to the per-call average where the marginal
    collapses below 5% of it."""
    run_chain(1)
    run_chain(n_rep)
    t0 = time.time()
    run_chain(1)
    wall_1 = time.time() - t0
    t0 = time.time()
    run_chain(n_rep)
    wall_k = time.time() - t0
    wall = (wall_k - wall_1) / max(n_rep - 1, 1)
    if wall < 0.05 * wall_k / n_rep:
        wall = wall_k / n_rep
    return wall_1, wall


def measure(hrom, cfg, info, cache_dir=None, card=None):
    """bench.py's accuracy and online halves on a built ``hrom`` (the
    serving windows as :func:`build` attached them): the served call
    timed, the fetch-inclusive variant, the routed fleet call beside it,
    K1's cost ledger at the served solve, the certification. ``info`` is
    :func:`build`'s. Returns {"payload": bench.py's payload, "cert",
    "est", "outs": the served batch's host arrays ((nt, …, B)), "mus":
    the timed batch, "fleet": the routed call's times, "ledger": the
    ledger's whole result}."""
    rom, fom = hrom.rom, hrom.fom
    device = rom.device
    n_windows, window_n = info["n_windows"], info["window_n"]
    n_online, n_rep = cfg["n_online"], cfg["n_rep"]
    serve_mode, engine = cfg["mode"], cfg["engine"]
    serve_dtype = torch.float32 if cfg["f32"] else torch.float64
    mus = bench_mus(rom, TIMED_SPACE, 3, n_online)
    if cfg["budget_gb"]:
        rom.ONLINE_PRECOMPUTE_BUDGET = int(float(cfg["budget_gb"]) * 1024**3)

    with compute_dtype_scope(serve_dtype):
        log(f"online: warm-up call (batch={n_online}, mode={serve_mode}) "
            f"on {device}")
        if cfg["autotune"]:
            log("online: autotuning matrices-vs-theta")
            tune = rom.autotune_online_precompute(mus, mode=serve_mode,
                                                  engine=engine, n_rep=n_rep)
            log(f"online: autotune -> {tune}")
        else:
            tune = rom.load_autotune(n_online, mode=serve_mode,
                                     engine=engine)
            if tune:
                log(f"online: autotune table pins '{tune['winner']}'")
        rom.solve_batch(mus, step=Stage.ONLINE, mode=serve_mode,
                        engine=engine, host=False)
        resolved = engine or rom._resolve_engine(serve_mode, n_online)
        batch = rom._mu_batch(mus)
        name0 = sorted(batch)[0]

        def served(b):
            return rom._serve_batch(b, resolved, serve_mode)

        def last(o):
            return o["uN_final"] if "uN_final" in o else o["uN"]

        def run_chain(reps):
            acc = torch.zeros((), dtype=batch[name0].dtype, device=device)
            for k in range(reps):
                b2 = dict(batch)
                b2[name0] = b2[name0] + acc * 1e-30 + k * 1e-9
                acc = last(served(b2)).sum()
            _sync(device)
            return float(acc)

        log("online: timing")
        wall_1, online_wall = marginal(run_chain, n_rep)
        outs_dev = rom.solve_batch(mus, step=Stage.ONLINE, mode=serve_mode,
                                   engine=engine, host=False)
        t0 = time.time()
        outs = {k: v.cpu().numpy() for k, v in outs_dev.items()}
        fetch_wall = time.time() - t0

        fetch_incl = None
        if serve_mode == "probes":
            spec = cfg["probe_reduce"]
            if spec.lstrip("-").isdigit():
                spec = int(spec)

            def run_chain_fetch(reps):
                acc = torch.zeros((), dtype=batch[name0].dtype,
                                  device=device)
                host = None
                for k in range(reps):
                    b2 = dict(batch)
                    b2[name0] = b2[name0] + acc * 1e-30 + k * 1e-9
                    o = served(b2)
                    host = rom._reduce_probes(o["probes"], spec).cpu().numpy()
                    acc = last(o).sum()
                _sync(device)
                return host

            log(f"online: fetch-inclusive timing (probe_reduce={spec!r})")
            _w1, fi_wall = marginal(run_chain_fetch, n_rep)
            fetch_incl = {"probe_reduce": str(spec),
                          "wall_s": round(fi_wall, 4),
                          "solves_per_sec": round(n_online / fi_wall, 1)}
            log(f"online: fetch-inclusive {fetch_incl['solves_per_sec']} "
                f"solves/s ({fi_wall:.4f} s/sweep incl. consumer fetch)")

        fleet = None
        if rom.mulocal is not None and serve_mode == "probes":
            walls = [timed(device, lambda: rom.solve_batch_mulocal(
                mus, mode=serve_mode))[1] for _ in range(n_rep + 1)]
            warm = statistics.median(walls[1:])
            fleet = {"n_cells": rom.mulocal.n_cells, "cold_s": walls[0],
                     "warm_s": walls[1:], "warm_median_s": warm,
                     "solves_per_sec": n_online / warm}
            log(f"online: routed fleet call solve_batch_mulocal "
                f"({rom.mulocal.n_cells} cells, B={n_online}): first "
                f"{walls[0] * 1e3:.1f} ms, then median {warm * 1e3:.1f} ms = "
                f"{n_online / warm:.1f} solves/s")
    solves_per_sec = n_online / online_wall
    log(f"online: {solves_per_sec:.1f} solves/s ({online_wall:.4f} s/sweep, "
        f"engine {resolved})")

    ledger = led = None
    if resolved == "windowed-pallas" and cfg["ledger"]:
        from .kernel_ledger import kernel_ledger, ledger_lines
        from .rom.engines.windowed_fused import sweep_inputs

        log("ledger: ablated kernel variants at the served solve")
        with compute_dtype_scope(torch.float32):
            served_solve = rom.windowed_solve()
            args, kw = sweep_inputs(fom, rom.windows, rom._prep_batch(batch),
                                    rom._windowed_tables(), served_solve)
            led = kernel_ledger(args, kw, reps=n_rep, served=served_solve)
            del args
        b = led["bench"]
        ledger = {"full_us_per_step": round(b["full_us_per_step"], 2),
                  "solve_us_per_step": round(b["solve_us_per_step"], 2),
                  "overhead_us_per_step": round(b["overhead_us_per_step"],
                                                2),
                  "dd_transfer_frac": round(b["dd_transfer_frac"], 4)}
        for line in ledger_lines(led, n_online):
            log(line)

    log("accuracy: certification")
    if n_windows > 0:
        probes = (outs_dev.get("probes") if serve_mode == "probes"
                  else None)
        cert, est = fleet_certification(hrom, mus, probes,
                                        n_multi=cfg["n_multi"],
                                        cache_dir=cache_dir)
    else:
        cert, est = global_certification(hrom, serve_dtype,
                                         cache_dir=cache_dir), None
    del outs_dev
    multi = cert["rel_l2_multi_mu"]
    log(f"accuracy: rel-L2 vs FOM {cert['rel_l2_vs_fom']:.4e}"
        + ("" if multi is None else
           f"; over {multi['n']} mu: mean {multi['mean']:.3e} max "
           f"{multi['max']:.3e}")
        + f"; served_engine_probe_err {cert['served_engine_probe_err']}"
        f"; f32 drift {cert['f32_serving_drift']:.3e}")
    ml = rom.mulocal
    payload = {
        "metric": "online_mu_rom_solves_per_sec",
        "value": round(solves_per_sec, 1),
        "unit": "solves/s",
        "vs_baseline": round(solves_per_sec / BASELINE_SOLVES_PER_SEC, 4),
        "rel_l2_vs_fom": cert["rel_l2_vs_fom"],
        "offline_wall_s": round(info["offline_wall"], 2),
        "extra": {
            "backend": device.type,
            "profile": cfg["profile"],
            "n_windows": n_windows,
            "window_n": window_n,
            "cell_wn": None if ml is None else [list(w)
                                                for w in ml.cell_wn],
            "registered_cells": None if ml is None else [
                c for c, w in enumerate(ml.cells)
                if w.dilation is not None],
            "nx": cfg["nx"],
            "nt": cfg["nt"],
            "rom_modes": int(rom.N),
            "batch": n_online,
            "mode": serve_mode,
            "engine": resolved,
            "offline_build": getattr(hrom.srom, "offline_snapshots_build",
                                     None),
            "solve_iters": (rom._windowed_solve_iters()
                            if n_windows > 0 else None),
            "host_fetch_wall_s": round(fetch_wall, 4),
            "fetch_inclusive": fetch_incl,
            "single_sweep_plus_sync_wall_s": round(wall_1, 4),
            "online_sweep_wall_s": round(online_wall, 4),
            "offline_wall_s": round(info["offline_wall"], 2),
            "rel_l2_vs_fom": cert["rel_l2_vs_fom"],
            "f32_serving_drift": cert["f32_serving_drift"],
            "timesteps_per_sec": round(solves_per_sec * cfg["nt"], 0),
            "served_engine_probe_err": cert["served_engine_probe_err"],
            "kernel_ledger": ledger,
            "rel_l2_multi_mu": multi,
            "rel_l2_multi_mu_std": cert["rel_l2_multi_mu_std"],
            "windowed_estimator": cert["windowed_estimator"],
            "precompute_autotune": tune,
            "device": card or card_line(device),
        },
    }
    return {"payload": payload, "cert": cert, "est": est, "outs": outs,
            "mus": mus, "fleet": fleet, "ledger": led}


def run(env=None, device=None):
    """The bench entry in the working directory: :func:`build`, then
    :func:`measure` (the FOM reference caches in the working directory).
    ``env``: bench.py's knobs (default ``os.environ``); ``device``: the
    torch device (default ``BENCH_DEVICE``, else the card). Returns the
    payload."""
    cfg = settings(env)
    device = resolve_device(device or cfg["device"])
    hrom, info = build(cfg, device)
    return measure(hrom, cfg, info, cache_dir=".")["payload"]


def main():
    """``bench.py``'s ``__main__`` (bench.py:1045-1068): the working
    directory ``BENCH_DIR`` (``tmp``: a throwaway one; default
    ``.bench_torch/`` beside the package), then :func:`run`, its payload
    printed as the last line."""
    device = resolve_device(os.environ.get("BENCH_DEVICE", "cuda"))
    bench_dir = os.environ.get("BENCH_DIR")
    if bench_dir == "tmp":
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            payload = run(device=device)
    else:
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        bench_dir = bench_dir or os.path.join(repo, ".bench_torch")
        os.makedirs(bench_dir, exist_ok=True)
        os.chdir(bench_dir)
        payload = run(device=device)
    print(json.dumps(payload, default=float))


if __name__ == "__main__":
    main()
