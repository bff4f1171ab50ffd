"""The piston pipeline (counterpart of ``romtime_tpu/rom/hrom.py``):
the offline build and the S-ROM error certification.

**Build** (the reference's form, ``HyperReducedPiston(grid, fom_params,
rom_params, deim_params, mdeim_params, mdeim_nonlinear_params, models,
rnd)``, on the card unless ``device="cpu"``)::

    hrom.setup()
    hrom.setup_hyperreduction()
    hrom.run_offline_rom(device_sweep=True)
    hrom.run_offline_hyperreduction(mu_space=hrom.mu_space["offline"],
                                    evaluate=False)
    hrom.project_reductors()

then the dumps (``dump_mu_space``, ``dump_reduced_basis``,
``dump_offline_snapshots``, ``dump_nonlinear_basis``; every reductor
pickles its collateral basis on training) into the working directory,
with the reference's names and formats, and the resume path
``start_from_existing_basis`` from them. The projected ROM and S-ROM
serve their own global configurations (``engine="pallas"`` through K4
and K5, ``engine="lanes"``). ``build_seconds`` holds the last build's
seconds per stage.

**Certification.** A sacrificial ROM (S-ROM) carries Δ more modes than
the ROM it certifies, its basis nesting the ROM's. Per (μ, t) the
estimator is the RMS of the reconstruction of the two trajectories'
difference, which, the S-ROM basis having orthonormal columns, is the
coefficient-difference norm ‖uN_srom − pad(uN)‖₂/√Nh: it never leaves
the reduced space. The two sweeps run on the device
(``solve_batch(..., host=False)``), the norm too, and only the (B, nt)
estimator is fetched. An estimator also comes from artifacts
(:meth:`HyperReducedPiston.from_serving`: ``convert
.estimator_from_arrays``, ``testing.synthetic.synthetic_estimator``).
"""

import os
import time

import numpy as np
import torch

from ..conventions import (
    Errors,
    OperatorType,
    RomParameters,
    Stage,
    StorageNames,
)
from ..deim import (
    DiscreteEmpiricalInterpolation,
    MatrixDiscreteEmpiricalInterpolation,
    MatrixDiscreteEmpiricalInterpolationNonlinear,
)
from ..fom import OneDimensionalBurgers
from ..utils import dump_json, dump_pickle, read_json, read_pickle
from ..utils.numeric import time_average
from .rom import RomConstructorNonlinear


class HyperReducedPiston:
    """The full nonlinear pipeline (reference ``hrom.py:57-337``,
    ``:1000-1058`` and ``:1425-1586``, the base pipeline's machinery and the
    piston's in one class: the heat path is not ported): the ROM and
    S-ROM pair, the RHS-DEIM, the mass, stiffness, convection and
    nonlinear-lifting MDEIM and the trilinear N-MDEIM."""

    def __init__(self, grid: dict, fom_params: dict, rom_params: dict,
                 deim_params: dict, mdeim_params: dict,
                 mdeim_nonlinear_params: dict, models: dict, rnd=None,
                 device="cuda") -> None:
        self.grid = grid
        self.fom_params = fom_params
        self.rom_params = rom_params
        self.deim_params = deim_params
        self.mdeim_params = mdeim_params
        self.mdeim_nonlinear_params = dict(mdeim_nonlinear_params)
        self.models = models
        self.rnd = rnd
        self.device = device

        self.fom = None
        self.rom = None
        self.srom = None
        self.deim_rhs = None
        self.mdeim_mass = None
        self.mdeim_stiffness = None
        self.mdeim_convection = None
        self.mdeim_nonlinear = None
        self.mdeim_trilinear = None
        self.mdeim_trilinear_lifting = None

        self.errors = dict()
        self.mu_space_deim = dict()
        self.validation_solutions = None
        self.windows_srom = None
        self.build_seconds = {}

    @classmethod
    def from_serving(cls, rom, srom=None, windows_srom=None):
        """An estimator on serving objects: ``rom`` the serving
        :class:`RomConstructorNonlinear`, ``srom`` the global S-ROM
        serving object (its basis nesting the ROM's) or None,
        ``windows_srom`` the :class:`~romtime_tpu_torch.rom.windowed
        .WindowedServing` at N+Δ whose windows nest the ROM's, or None."""
        hrom = cls(grid=rom.grid, fom_params=None, rom_params=None,
                   deim_params=None, mdeim_params=None,
                   mdeim_nonlinear_params={}, models=None,
                   device=rom.device)
        hrom.fom = rom.fom
        hrom.rom = rom
        hrom.srom = srom
        hrom.windows_srom = windows_srom
        return hrom

    # ------------------------------------------------------------------
    # Accessors
    # ------------------------------------------------------------------
    @property
    def mu_space(self):
        return self.rom.mu_space

    @property
    def basis(self):
        """The reduced-order basis V."""
        return self.rom.basis

    # ------------------------------------------------------------------
    # Persistence (reference hrom.py:123-207)
    # ------------------------------------------------------------------
    def dump_mu_space(self, path=None):
        dump_json(path or StorageNames.MU_SPACE, self.mu_space)

    def dump_mu_space_deim(self, path=None):
        dump_json(path or StorageNames.MU_SPACE_DEIM, self.mu_space_deim)

    def dump_reduced_basis(self, path=None):
        dump_pickle(StorageNames.ROM, np.asarray(self.basis))
        if self.srom is not None and self.srom.basis is not None:
            dump_pickle(StorageNames.SROM, np.asarray(self.srom.basis))

    def dump_offline_snapshots(self, path=None):
        """The retained per-μ FOM snapshot matrices and their build
        precision (``__build__``), as the reference's npz."""
        payload = {f"s{i}": np.asarray(s)
                   for i, s in enumerate(self.srom.offline_snapshots)}
        build = self.srom.offline_snapshots_build
        if build is not None:
            payload["__build__"] = np.asarray(build)
        np.savez(path or StorageNames.SNAPSHOTS, **payload)

    def load_offline_snapshots(self, path=None):
        path = path or StorageNames.SNAPSHOTS
        if not os.path.exists(path):
            return False
        with np.load(path) as data:
            build = str(data["__build__"]) if "__build__" in data else None
            n = len([k for k in data.files if k.startswith("s")])
            snaps = [data[f"s{i}"] for i in range(n)]
        self.srom.offline_snapshots = snaps
        self.srom.offline_snapshots_build = build
        return True

    def dump_nonlinear_basis(self, path=None):
        dump_pickle(f"basis_fom_n-mdeim_{OperatorType.TRILINEAR}.pkl",
                    np.asarray(self.srom.basis_nonlinear))

    def load_validation_fom(self, path=None):
        try:
            self.validation_solutions = read_pickle(
                path or StorageNames.VALIDATION_SOLUTIONS)
        except FileNotFoundError:
            print("Validation solutions are not defined.")

    # ------------------------------------------------------------------
    # Setup (reference hrom.py:210-274, :1452-1510)
    # ------------------------------------------------------------------
    def _create_fom(self):
        fp = self.fom_params
        return OneDimensionalBurgers(
            domain=fp.get("domain"), dirichlet=fp.get("dirichlet"),
            parameters=fp.get("parameters", None),
            forcing_term=fp.get("forcing_term"), u0=fp.get("u0"),
            exact_solution=fp.get("exact_solution", None),
            Lt=fp.get("Lt"), dLt_dt=fp.get("dLt_dt"), device=self.device)

    def _create_rom(self, fom, name="ROM"):
        return RomConstructorNonlinear(fom=fom, grid=self.grid, name=name,
                                       device=self.device)

    def setup(self):
        """Create the FOM and the ROM and S-ROM structures."""
        fom = self._create_fom()
        fom.setup()
        rom = self._create_rom(fom, name="ROM")
        rom.setup(rnd=self.rnd)
        srom = self._create_rom(fom, name="S-ROM")
        srom.setup(rnd=self.rnd)
        self.rom = rom
        self.srom = srom
        self.fom = fom

    def setup_hyperreduction(self):
        """The RHS-DEIM, the mass, stiffness, convection and
        nonlinear-lifting MDEIM and the trilinear and nonlinear N-MDEIM,
        each with its topology probed."""
        fom, grid = self.fom, self.grid
        lin, nl = self.mdeim_params, self.mdeim_nonlinear_params
        MDEIM = MatrixDiscreteEmpiricalInterpolation
        NMDEIM = MatrixDiscreteEmpiricalInterpolationNonlinear
        self.deim_rhs = DiscreteEmpiricalInterpolation(
            name="RHS", assemble=fom.assemble_rhs, grid=grid,
            tree_walk_params=self.deim_params)
        self.mdeim_mass = MDEIM(name="Mass", assemble=fom.assemble_mass,
                                grid=grid, tree_walk_params=lin)
        self.mdeim_stiffness = MDEIM(
            name="Stiffness", assemble=fom.assemble_stiffness, grid=grid,
            tree_walk_params=lin)
        self.mdeim_convection = MDEIM(
            name=OperatorType.CONVECTION, assemble=fom.assemble_convection,
            grid=grid, tree_walk_params=lin)
        self.mdeim_trilinear_lifting = MDEIM(
            name=OperatorType.NONLINEAR_LIFTING,
            assemble=fom.assemble_nonlinear_lifting, grid=grid,
            tree_walk_params=lin)
        self.mdeim_trilinear = NMDEIM(
            name=OperatorType.TRILINEAR, assemble=fom.assemble_trilinear,
            grid=grid, tree_walk_params=nl)
        self.mdeim_nonlinear = NMDEIM(
            name=OperatorType.NONLINEAR, assemble=fom.assemble_nonlinear,
            grid=grid, tree_walk_params=nl)
        for obj in (self.deim_rhs, self.mdeim_mass, self.mdeim_stiffness,
                    self.mdeim_convection, self.mdeim_trilinear_lifting,
                    self.mdeim_trilinear, self.mdeim_nonlinear):
            obj.setup(rnd=self.rnd)

    # ------------------------------------------------------------------
    # Offline phases (reference hrom.py:276-336, :1512-1569)
    # ------------------------------------------------------------------
    def run_offline_rom(self, mu_space=None, device_sweep=False, mesh=None):
        """Build the S-ROM basis, then truncate it into the ROM;
        ``device_sweep`` sweeps the FOM over the μ list as one batch
        (``RomConstructorNonlinear.build_reduced_basis``)."""
        rp = self.rom_params
        srom = self.srom
        fom_solutions = srom.build_reduced_basis(
            num_snapshots=rp[RomParameters.NUM_SNAPSHOTS],
            mu_space=mu_space, num_basis=rp.get(RomParameters.NUM_MU),
            tolerances={
                RomParameters.TOL_TIME: rp.get(RomParameters.TOL_TIME),
                RomParameters.TOL_MU: rp.get(RomParameters.TOL_MU)},
            device_sweep=device_sweep, mesh=mesh)
        self.build_seconds.update(srom.build_seconds)
        rom = srom.truncate(n=rp[RomParameters.SROM_TRUNCATE])
        rom.name = "ROM"
        self.rom = rom
        self.validation_solutions = fom_solutions

    def run_offline_hyperreduction(self, mu_space=None, u_n=None,
                                   evaluate=True):
        """The collateral bases: stiffness, mass, RHS, convection, the
        nonlinear lifting, then the trilinear N-MDEIM (its basis the
        FOM-captured nonlinear snapshots' when the S-ROM has one)."""
        for which, obj, run in (
                (OperatorType.STIFFNESS, self.mdeim_stiffness,
                 self._run_mdeim),
                (OperatorType.MASS, self.mdeim_mass, self._run_mdeim),
                (OperatorType.RHS, self.deim_rhs, self._run_deim),
                (OperatorType.CONVECTION, self.mdeim_convection,
                 self._run_mdeim),
                (OperatorType.NONLINEAR_LIFTING,
                 self.mdeim_trilinear_lifting, self._run_mdeim)):
            if self.models.get(which):
                run(object=obj, which=which, evaluate=evaluate,
                    mu_space=mu_space)
        if self.models.get(OperatorType.TRILINEAR):
            self._run_mdeim_nonlinear(
                object=self.mdeim_trilinear, mu_space=mu_space,
                evaluate=evaluate, which=OperatorType.TRILINEAR,
                u_n=self.basis if u_n is None else u_n,
                basis=self.srom.basis_nonlinear)

    def project_reductors(self):
        t0 = time.perf_counter()
        self.rom.project_reductors()
        self.srom.project_reductors()
        self.build_seconds["projection"] = time.perf_counter() - t0

    def evaluate_deim_model(self, object, mu_space):
        params = object.tree_walk_params
        object.evaluate(ts=params[RomParameters.TS],
                        num=params.get(RomParameters.NUM_ONLINE),
                        mu_space=mu_space)

    def _run_deim(self, object, which, mu_space, evaluate=False):
        """Train a (M)DEIM, pickle its collateral basis and attach it to
        the ROM and the S-ROM (reference ``hrom.py:1278-1295``)."""
        t0 = time.perf_counter()
        object.run(mu_space=mu_space)
        object.dump_fom_basis()
        self.build_seconds[object.name] = time.perf_counter() - t0
        if evaluate:
            self.evaluate_deim_model(object=object, mu_space=mu_space)
        for rom in (self.rom, self.srom):
            rom.add_hyper_reductor(reductor=object, which=which)

    def _run_mdeim(self, object, which, mu_space, evaluate=False):
        self._run_deim(object=object, which=which, mu_space=mu_space,
                       evaluate=evaluate)

    def _run_mdeim_nonlinear(self, object, u_n, which, mu_space,
                             evaluate=False, basis=None):
        """Train the N-MDEIM, or adopt ``basis`` (the FOM-captured
        nonlinear basis) kept to ``NMDEIM_SIZE`` columns; either is
        pickled (reference ``hrom.py:1548-1569``)."""
        t0 = time.perf_counter()
        if basis is None:
            object.run(u_n=u_n, mu_space=mu_space)
            object.dump_fom_basis()
            if evaluate:
                self.evaluate_deim_model(object=object, mu_space=mu_space)
        else:
            object.u_n = None if u_n is None else np.asarray(u_n)
            if object.u_n is not None and object.u_n.ndim == 1:
                object.u_n = object.u_n.reshape((-1, 1))
            object.load_fom_basis(
                basis=basis,
                keep=self.rom_params.get(RomParameters.NMDEIM_SIZE))
            object.dump_fom_basis()
        self.build_seconds[object.name] = time.perf_counter() - t0
        for rom in (self.rom, self.srom):
            rom.add_hyper_reductor(reductor=object, which=which)

    # ------------------------------------------------------------------
    # Resume (reference hrom.py:1000-1058, :1571-1586)
    # ------------------------------------------------------------------
    def start_from_existing_basis(self):
        """Resume from the working directory's dumps: the μ space, the
        S-ROM basis (kept to ``SROM_KEEP``) truncated into the ROM, every
        reductor's collateral basis, and the windowed configurations and
        offline snapshots where they were persisted."""
        from .windowed import MuLocalWindowed, WindowedServing

        self.load_validation_fom()
        try:
            mu_space = read_json(StorageNames.MU_SPACE)
        except FileNotFoundError:
            mu_space = {Stage.OFFLINE: list(), Stage.ONLINE: list(),
                        Stage.VALIDATION: list()}
        basis_srom = read_pickle(StorageNames.SROM)
        N_srom = self.rom_params.get(RomParameters.SROM_KEEP)
        if N_srom is not None:
            basis_srom = basis_srom[:, :N_srom]
        self.srom.load_from_basis(basis=basis_srom, mu_space=mu_space)
        self.rom = self.srom.truncate(
            self.rom_params[RomParameters.SROM_TRUNCATE])

        for reductor, which in zip(*self._resume_reductors()):
            for _rom in (self.rom, self.srom):
                _rom.add_hyper_reductor(reductor=reductor, which=which)

        if os.path.exists(StorageNames.WINDOWS):
            self.rom._set_serving_windows(
                WindowedServing.load(StorageNames.WINDOWS))
        if os.path.exists(StorageNames.WINDOWS_SROM):
            self.windows_srom = WindowedServing.load(
                StorageNames.WINDOWS_SROM)
        if os.path.exists(StorageNames.WINDOWS_MULOCAL):
            self.rom.mulocal = MuLocalWindowed.load(
                StorageNames.WINDOWS_MULOCAL)
        self.load_offline_snapshots()

    def _resume_reductors(self):
        """Every reductor's collateral basis from its pickle (the
        trilinear N-MDEIM kept to ``NMDEIM_SIZE``)."""
        deims = [self.deim_rhs, self.mdeim_mass, self.mdeim_stiffness,
                 self.mdeim_convection, self.mdeim_trilinear_lifting]
        for obj in deims:
            obj.load_fom_basis()
        self.mdeim_trilinear.load_fom_basis(
            keep=self.rom_params.get(RomParameters.NMDEIM_SIZE))
        return (deims + [self.mdeim_trilinear],
                [OperatorType.RHS, OperatorType.MASS, OperatorType.STIFFNESS,
                 OperatorType.CONVECTION, OperatorType.NONLINEAR_LIFTING,
                 OperatorType.TRILINEAR])

    # ------------------------------------------------------------------
    # S-ROM certification (reference hrom.py:1149-1258)
    # ------------------------------------------------------------------
    def estimate_batch(self, mus, step=Stage.ONLINE, engine=None):
        """Batched S-ROM certification (reference ``hrom.py:1149-1217``):
        one lanes sweep per ROM in ``mode="reduced"``, in the compute dtype
        (float64 under ``compute_dtype_scope``, as the reference certifies
        with x64 on).

        ``engine="windowed"``: both sweeps on the windowed lanes engine,
        the second with ``windows_srom`` swapped in as the active windows
        (restored after, whatever happens); Nh is the windows' row count.
        Otherwise ``rom`` and ``srom`` each serve ``solve_batch(mode=
        "reduced")``, which resolves to the global lanes engine; Nh is the
        S-ROM basis's row count.

        Returns ``estimator`` (B, nt) and ``average`` (B,) (trapezoid time
        averages, each over its μ's own clock on registered windows) as
        numpy, and the two sweeps' raw outputs under ``"rom"``
        and ``"srom"`` as their (nt, …, B) device tensors (the reference
        returns them batch-first on the host; here only the estimator
        crosses to the host)."""
        rom = self.rom
        if engine == "windowed":
            if rom.windows is None or self.windows_srom is None:
                raise ValueError("windowed estimation needs the ROM's windows "
                                 "and the nested S-ROM windows "
                                 "(windows_srom)")
            out_rom = rom.solve_batch(mus, step=step, mode="reduced",
                                      engine="windowed", host=False)
            serving = rom.windows
            rom._set_serving_windows(self.windows_srom)
            try:
                out_srom = rom.solve_batch(mus, step=step, mode="reduced",
                                           engine="windowed", host=False)
            finally:
                rom._set_serving_windows(serving)
            Nh = np.asarray(serving.Vs).shape[1]
        else:
            if self.srom is None:
                raise ValueError("global estimation needs the S-ROM serving "
                                 "object (srom)")
            out_rom = rom.solve_batch(mus, step=step, mode="reduced",
                                      host=False)
            out_srom = self.srom.solve_batch(mus, step=step, mode="reduced",
                                             host=False)
            Nh = np.asarray(self.srom.global_serving.basis).shape[0]

        uN = out_rom["uN"]                          # (nt, N, B)
        diff = out_srom["uN"].clone()               # (nt, N̂, B)
        diff[:, :uN.shape[1]] -= uN
        estimator = (torch.linalg.vector_norm(diff, dim=1)
                     / np.sqrt(Nh)).T.cpu().numpy()  # (B, nt)
        ts = out_rom["t"].cpu().numpy()
        if ts.ndim == 2:
            # Registered windows: each lane on its own dilated clock
            # (nt, B). The reference broadcasts every lane's clock against
            # each series there and returns a (B, B) average; each μ is
            # averaged over its own clock here.
            average = np.array([time_average(ts[:, b], e)
                                for b, e in enumerate(estimator)])
        else:
            average = np.array([time_average(ts, e) for e in estimator])
        self.errors[f"{step}-estimator"] = {
            idx: estimator[idx] for idx in range(len(mus))}
        return {Errors.ESTIMATOR: estimator,
                Errors.AVERAGE_ESTIMATOR: average,
                "rom": out_rom, "srom": out_srom}

    def estimate_batch_mulocal(self, mus, step=Stage.ONLINE):
        """S-ROM certification of the μ-local fleet (reference
        ``hrom.py:1219-1258``): each μ is routed to its Mach cell
        (``route_mulocal``) and estimated on the windowed branch against
        that cell's nested S-ROM windows (``mulocal.cells_srom``).
        ``windows_srom`` is restored after, whatever happens. Returns
        ``estimator`` (B, nt) and ``average`` (B,), and each μ's two
        trajectories, ``"rom"`` (nt, N) and ``"srom"`` (nt, N̂) rows on the
        host (a list of rows where the cells' N differ), all merged back
        in input order (the reference returns the first two only)."""
        rom = self.rom
        ml = rom.mulocal
        if ml is None or ml.cells_srom is None:
            raise ValueError("μ-local estimation needs a fleet with nested "
                             "S-ROM cells (mulocal.cells_srom)")
        prev_srom = self.windows_srom

        def run_cell(c, sub):
            self.windows_srom = ml.cells_srom[c]
            out = self.estimate_batch(sub, step=step, engine="windowed")
            return {Errors.ESTIMATOR: out[Errors.ESTIMATOR],
                    Errors.AVERAGE_ESTIMATOR: out[Errors.AVERAGE_ESTIMATOR],
                    **{key: out[key]["uN"].movedim(-1, 0).cpu().numpy()
                       for key in ("rom", "srom")}}

        try:
            merged = rom.route_mulocal(mus, run_cell)
        finally:
            self.windows_srom = prev_srom
        self.errors[f"{step}-estimator"] = {
            idx: merged[Errors.ESTIMATOR][idx] for idx in range(len(mus))}
        return merged

