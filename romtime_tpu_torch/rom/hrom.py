"""The HROM drivers (counterpart of ``romtime_tpu/rom/hrom.py``): the
offline build and the S-ROM error certification of the heat family on
the fixed domain (:class:`HyperReducedOrderModelFixed`: mass, stiffness
and RHS reductors) and the moving one
(:class:`HyperReducedOrderModelMoving`: plus the convection), and of the
piston (:class:`HyperReducedPiston`, a subclass of the fixed driver as
in the reference: plus the convection, the nonlinear lifting and the
trilinear N-MDEIM, and the μ-local fleet).

**Build** (the reference's forms, ``HyperReducedOrderModelFixed(grid,
fom_params, rom_params, deim_params, mdeim_params, models, rnd)`` and
``HyperReducedPiston(..., mdeim_nonlinear_params, models, rnd)``, on
the card unless ``device="cpu"``)::

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

**Evaluation** (reference ``hrom.py:1060-1147``, ``:1261-1368``,
``:1588-1650``): ``evaluate_validation`` (the offline μ against the
build's FOM trajectories) and ``evaluate_online`` (fresh μ against the
FOM solved for each) run ``solve`` on the ROM and the S-ROM per μ and
keep the per-step errors and the S-ROM estimator in ``errors``,
computed from the fetched trajectories; the piston's probe and
mass-conservation CSVs; ``evaluate_deim``; the dumps
(``dump_validation_fom``, ``dump_errors``, ``dump_errors_deim``,
``dump_setup``) and ``generate_summary``, whose tables are dicts of
columns (no pandas). The CSVs carry the reference's names, columns and
index.

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
import sys
import time
import zipfile
from collections import defaultdict

import numpy as np
import torch

from ..conventions import (
    Errors,
    OperatorType,
    ProbeLocations,
    ProblemType,
    RomParameters,
    Stage,
    StorageNames,
    Treewalk,
    TreewalkNonlinear,
)
from ..deim import (
    DiscreteEmpiricalInterpolation,
    MatrixDiscreteEmpiricalInterpolation,
    MatrixDiscreteEmpiricalInterpolationNonlinear,
)
from ..deim.deim import offline
from ..dtypes import compute_dtype_scope
from ..fom import (
    HeatEquationMovingSolver,
    HeatEquationSolver,
    OneDimensionalBurgers,
)
from ..utils import dump_csv, dump_json, dump_pickle, read_json, read_pickle
from ..utils.io import write_table
from ..utils.numeric import time_average
from .base import SUMMARY_COLUMNS
from .rom import RomConstructor, RomConstructorMoving, RomConstructorNonlinear


def _rms_columns(e):
    """The RMS of each column of ``e`` (nh, nt): the reference's
    ``Reductor._compute_error`` (``rom/base.py:46-51``) at every step at
    once."""
    return np.linalg.norm(e, axis=0) / np.sqrt(e.shape[0])


def _write_indexed(path, table):
    """A dict of columns with its row labels under ``"index"`` as the
    reference's ``DataFrame.to_csv`` writes it."""
    write_table(path, {k: v for k, v in table.items() if k != "index"},
                table["index"])


class HyperReducedOrderModelFixed:
    """The heat driver on the fixed domain (reference ``hrom.py:57-1366``):
    the ROM and S-ROM pair, the RHS-DEIM and the mass and stiffness
    MDEIM; the base of every driver."""

    def __init__(self, grid: dict, fom_params: dict, rom_params: dict,
                 deim_params: dict, mdeim_params: dict, models: dict,
                 rnd=None, device="cuda") -> None:
        self.grid = grid
        self.fom_params = fom_params
        self.rom_params = rom_params
        self.deim_params = deim_params
        self.mdeim_params = mdeim_params
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

        self.deim_runned = False
        self.rom_runned = False

        self.errors = dict()
        self.online_params = None
        self.summary_basis = defaultdict(dict)
        self._summary_basis = defaultdict(dict)
        self.summary_errors = defaultdict(dict)
        self.summary_errors_deim = defaultdict(dict)
        self.summary_sigmas = defaultdict(dict)
        self.summary_energy = defaultdict(dict)
        self.mu_space_deim = dict()
        self.validation_solutions = None
        self.windows_srom = None
        self.build_seconds = {}

    @classmethod
    def from_serving(cls, rom, srom=None, windows_srom=None):
        """An estimator on serving objects: ``rom`` the serving ROM,
        ``srom`` the global S-ROM serving object (its basis nesting the
        ROM's) or None, ``windows_srom`` the
        :class:`~romtime_tpu_torch.rom.windowed.WindowedServing` at N+Δ
        whose windows nest the ROM's, or None."""
        hrom = cls(grid=rom.sampling_grid, fom_params=None, rom_params=None,
                   deim_params=None, mdeim_params=None, models=None,
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

    def load_validation_fom(self, path=None):
        try:
            self.validation_solutions = read_pickle(
                path or StorageNames.VALIDATION_SOLUTIONS)
        except FileNotFoundError:
            print("Validation solutions are not defined.")

    # ------------------------------------------------------------------
    # Setup (reference hrom.py:210-274)
    # ------------------------------------------------------------------
    def _fom_kwargs(self):
        fp = self.fom_params
        return dict(
            domain=fp.get("domain"), dirichlet=fp.get("dirichlet"),
            parameters=fp.get("parameters", None),
            forcing_term=fp.get("forcing_term"), u0=fp.get("u0"),
            exact_solution=fp.get("exact_solution", None), device=self.device)

    def _create_fom(self):
        return HeatEquationSolver(**self._fom_kwargs())

    def _create_rom(self, fom, name="ROM"):
        return RomConstructor(fom=fom, grid=self.grid, name=name,
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
        """The RHS-DEIM and the mass and stiffness MDEIM."""
        fom, grid, lin = self.fom, self.grid, self.mdeim_params
        MDEIM = MatrixDiscreteEmpiricalInterpolation
        self.deim_rhs = DiscreteEmpiricalInterpolation(
            name="RHS", assemble=fom.assemble_rhs, grid=grid,
            tree_walk_params=self.deim_params)
        self.mdeim_mass = MDEIM(name="Mass", assemble=fom.assemble_mass,
                                grid=grid, tree_walk_params=lin)
        self.mdeim_stiffness = MDEIM(
            name="Stiffness", assemble=fom.assemble_stiffness, grid=grid,
            tree_walk_params=lin)
        for obj in (self.deim_rhs, self.mdeim_mass, self.mdeim_stiffness):
            obj.setup(rnd=self.rnd)

    # ------------------------------------------------------------------
    # Offline phases (reference hrom.py:276-336, :1512-1569)
    # ------------------------------------------------------------------
    def run_offline_rom(self, mu_space=None, device_sweep=False, mesh=None):
        """Build the S-ROM basis, then truncate it into the ROM;
        ``device_sweep`` sweeps the FOM over the μ list as one batch,
        sharded over ``mesh`` where it has more than one shard
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
        self.rom_runned = True

    def run_offline_hyperreduction(self, mu_space=None, evaluate=True):
        """The collateral bases of the linear operators: stiffness, mass
        and RHS, each as ``models`` asks."""
        for which, obj, run in (
                (OperatorType.STIFFNESS, self.mdeim_stiffness,
                 self._run_mdeim),
                (OperatorType.MASS, self.mdeim_mass, self._run_mdeim),
                (OperatorType.RHS, self.deim_rhs, self._run_deim)):
            if self.models.get(which):
                run(object=obj, which=which, evaluate=evaluate,
                    mu_space=mu_space)
        self.deim_runned = True

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

    # ------------------------------------------------------------------
    # Windowed serving builds (reference hrom.py:338-376, :977-998)
    # ------------------------------------------------------------------
    def build_windowed_serving(self, n_windows, num_basis, snapshots=None,
                               overlap=2, dump=True, srom_extra=None):
        """The ROM's windowed serving from the retained offline snapshots
        (reference ``hrom.py:338-376``), dumped to
        ``StorageNames.WINDOWS``. ``srom_extra``: build at ``num_basis +
        srom_extra`` modes, keep that build as ``windows_srom`` (dumped to
        ``StorageNames.WINDOWS_SROM``) and serve its nested truncation
        (``WindowedServing.truncate``)."""
        if snapshots is None:
            snapshots = self.srom.offline_snapshots
        if srom_extra:
            enriched = self.rom.build_windowed_serving(
                n_windows=n_windows, num_basis=num_basis + srom_extra,
                snapshots=snapshots, overlap=overlap)
            self.windows_srom = enriched
            windows = enriched.truncate(num_basis)
            self.rom._set_serving_windows(windows)
            if dump:
                enriched.dump(StorageNames.WINDOWS_SROM)
        else:
            windows = self.rom.build_windowed_serving(
                n_windows=n_windows, num_basis=num_basis,
                snapshots=snapshots, overlap=overlap)
        if dump:
            windows.dump(StorageNames.WINDOWS)
        return windows

    def build_windowed_srom(self, n_windows, num_basis, snapshots=None,
                            overlap=2, dump=True):
        """Only the sacrificial windowed configuration (``windows_srom``),
        the ROM's serving windows kept (reference ``hrom.py:977-998``)."""
        if snapshots is None:
            snapshots = self.srom.offline_snapshots
        current = self.rom.windows
        try:
            self.windows_srom = self.rom.build_windowed_serving(
                n_windows=n_windows, num_basis=num_basis,
                snapshots=snapshots, overlap=overlap)
        finally:
            self.rom._set_serving_windows(current)
        if dump:
            self.windows_srom.dump(StorageNames.WINDOWS_SROM)
        return self.windows_srom

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
            if reductor is None:
                continue
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
        """The RHS-DEIM and the mass and stiffness MDEIM from their
        pickles."""
        deims = [self.deim_rhs, self.mdeim_mass, self.mdeim_stiffness]
        for obj in deims:
            obj.load_fom_basis()
        return deims, [OperatorType.RHS, OperatorType.MASS,
                       OperatorType.STIFFNESS]

    # ------------------------------------------------------------------
    # Evaluation (reference hrom.py:1060-1147, :1588-1650)
    # ------------------------------------------------------------------
    def solve(self, mu, step):
        self.rom.solve(mu, step)

    def evaluate_validation(self):
        """The ROM and S-ROM on the offline μ against the FOM
        trajectories of the build (``validation_solutions``)."""
        self._evaluate(which=Stage.VALIDATION,
                       mu_space=self.rom.mu_space[Stage.OFFLINE])

    def evaluate_online(self, params, rnd=None):
        """The ROM and S-ROM on ``params["num"]`` fresh μ from the
        Mach-stratified sampler against the FOM solved for each, in the
        compute dtype (``fom.solve()``)."""
        self.online_params = params
        space = self.rom.build_sampling_space(num=params["num"], rnd=rnd)
        self._evaluate(which=Stage.ONLINE, mu_space=space)

    def _evaluate(self, which, mu_space=None):
        """Per μ: ``solve`` on the ROM and the S-ROM (each solution
        pickled as ``solutions_{rom,srom}_<N>_<which>_<idx>``), the FOM
        truth, and from the fetched numpy trajectories the per-step RMS
        errors of both against it and the S-ROM estimator
        ‖V_srom·(u_srom − pad(u_N))‖₂/√Nh
        (``utils.numeric.compute_rom_difference`` for every step at once);
        then :meth:`_postprocess_mu`. ``errors[which]`` maps each μ index
        to its ``estimator``, ``rom`` and ``sacrificial`` series (the ROM's
        exact-solution errors instead where the FOM has an exact
        solution); ``errors[f"{which}-vs-fom"]`` always the former."""
        fom, rom, srom = self.fom, self.rom, self.srom
        rom_fom_errors = dict()
        for mu in list(mu_space):
            idx_mu = rom.solve(mu=mu, step=which)
            srom.solve(mu=mu, step=which)
            rom.solutions.to_pickle(f"solutions_rom_{rom.N}_{which}_{idx_mu}")
            srom.solutions.to_pickle(
                f"solutions_srom_{srom.N}_{which}_{idx_mu}")
            if which == Stage.VALIDATION:
                uh_fom = self.validation_solutions[idx_mu]
            else:
                fom.setup()
                fom.update_parametrization(mu)
                fom.solve()
                uh_fom = fom.solutions.fom
            uh_fom = np.asarray(uh_fom)
            V_srom = np.asarray(srom.basis)
            uN, uN_srom = rom.solutions.rom, srom.solutions.rom
            diff = np.array(uN_srom, np.float64)
            diff[:uN.shape[0]] -= uN
            rom_fom_errors[idx_mu] = {
                Errors.ESTIMATOR: (np.linalg.norm(V_srom @ diff, axis=0)
                                   / np.sqrt(V_srom.shape[0])),
                Errors.ROM: _rms_columns(uh_fom - rom.solutions.fom),
                Errors.SACRIFICIAL: _rms_columns(uh_fom
                                                 - srom.solutions.fom),
            }
            self._postprocess_mu(which, idx_mu, mu, uh_fom)
        if fom.exact_solution is None:
            self.errors[which] = rom_fom_errors
        else:
            self.errors[which] = dict(rom.errors)
        self.errors[f"{which}-vs-fom"] = rom_fom_errors

    def _postprocess_mu(self, which, idx_mu, mu, uh_fom):
        """Hook: the piston's probe and mass-conservation reports."""
        pass

    # ------------------------------------------------------------------
    # DEIM evaluation and the reports (reference hrom.py:166-197,
    # :1261-1368)
    # ------------------------------------------------------------------
    def evaluate_deim(self):
        """Every trained reductor's interpolation error on the offline μ
        (each reductor's ``errors_rom``)."""
        mu_space = self.mu_space[Stage.OFFLINE]
        for obj in (self.deim_rhs, self.mdeim_mass, self.mdeim_stiffness,
                    self.mdeim_convection, self.mdeim_trilinear_lifting,
                    self.mdeim_trilinear):
            if obj is not None:
                self.evaluate_deim_model(object=obj, mu_space=mu_space)

    def dump_validation_fom(self, path=None):
        dump_pickle(path or StorageNames.VALIDATION_SOLUTIONS,
                    self.validation_solutions)

    def dump_errors(self, which, path=None):
        """``errors_<which>.csv`` in ``path`` (default the working
        directory): the reference's ``DataFrame(errors[which])``, a column
        per μ index and a row per error series, each cell its series as
        numpy prints it."""
        if which not in self.errors:
            raise Warning(f"These errors ({which}) have not been computed "
                          "yet.")
        errors = self.errors[which]
        rows = list(dict.fromkeys(k for v in errors.values() for k in v))
        write_table(os.path.join(path or ".", f"errors_{which}.csv"),
                    {idx: [v.get(r, np.nan) for r in rows]
                     for idx, v in errors.items()}, rows)

    def dump_errors_deim(self, path=None):
        """``errors_deim_<operator>.csv`` for every operator of
        ``summary_errors_deim`` with errors: a column per μ index, a row
        per time."""
        for operator, errors in self.summary_errors_deim.items():
            if errors:
                dump_csv(os.path.join(path or ".", "errors_deim_"
                                      f"{operator.lower()}.csv"), errors)

    def dump_setup(self, path):
        """The configuration as JSON (``StorageNames.SETUP`` without a
        path): the FOM's domain, the μ box's distributions, the ROM, DEIM
        and MDEIM parameters (without their time grids) and the online
        evaluation's."""
        def without_ts(params):
            return {k: v for k, v in params.items() if k != RomParameters.TS}

        dump_json(path or StorageNames.SETUP, {
            "fom_params": self.fom_params.get("domain"),
            "mu_space": self.fom_params.get("grid_params"),
            "rom_params": self.rom_params,
            "deim_params": without_ts(self.deim_params),
            "mdeim_params": without_ts(self.mdeim_params),
            "online_params": self.online_params})

    def generate_summary(self):
        """The build's summaries, as dicts of columns with their row
        labels under ``"index"`` where the reference builds DataFrames
        (a stated departure, as ``Reductor.create_errors_summary``):
        ``summary_basis`` (a row per basis: the reduced basis, the
        trilinear N-MDEIM's and each trained reductor's, columns the
        tree walk's and the final basis size), ``summary_errors`` (a row
        per μ of the ROM's exact-solution errors: mean, median, max,
        min); ``summary_sigmas``, ``summary_energy``,
        ``summary_errors_deim`` and ``mu_space_deim`` per operator."""
        basis = self._summary_basis
        sig, energy = self.summary_sigmas, self.summary_energy
        report = self.rom.report[Stage.OFFLINE]
        WALK, FINAL = Treewalk.BASIS_AFTER_WALK, Treewalk.BASIS_FINAL
        SPECTRUM, ENERGY = Treewalk.SPECTRUM_MU, Treewalk.ENERGY_MU
        RB, TRI = OperatorType.REDUCED_BASIS, OperatorType.TRILINEAR
        basis[RB][WALK] = report[WALK]
        basis[RB][FINAL] = report[FINAL]
        sig[RB][SPECTRUM] = report[SPECTRUM]
        energy[RB][ENERGY] = report[ENERGY]
        basis[TRI][WALK] = report[TreewalkNonlinear.BASIS_AFTER_WALK]
        basis[TRI][FINAL] = report[TreewalkNonlinear.BASIS_FINAL]
        sig[TRI][SPECTRUM] = report[TreewalkNonlinear.SPECTRUM_MU]
        energy[TRI][ENERGY] = report[TreewalkNonlinear.ENERGY_MU]
        for operator in (self.deim_rhs, self.mdeim_mass,
                         self.mdeim_stiffness, self.mdeim_convection,
                         self.mdeim_trilinear_lifting):
            if operator is not None:
                self.generate_operator_summary(
                    operator, basis=basis, sigma=sig, energy=energy,
                    errors_deim=self.summary_errors_deim,
                    mu_space_deim=self.mu_space_deim)
        self.summary_basis = {"index": list(basis), **{
            col: [basis[name].get(col) for name in basis]
            for col in (WALK, FINAL)}}
        reducers = dict(zip(SUMMARY_COLUMNS,
                            (np.mean, np.median, np.max, np.min)))
        index = list(self.rom.errors)
        self.summary_errors = {"index": index, **{
            col: [float(fn(self.rom.errors[i])) for i in index]
            for col, fn in reducers.items()}}

    @staticmethod
    def generate_operator_summary(operator, basis, sigma, energy, errors_deim,
                                  mu_space_deim):
        """One reductor's rows of the summaries (reference
        hrom.py:1351-1366)."""
        WALK, FINAL = Treewalk.BASIS_AFTER_WALK, Treewalk.BASIS_FINAL
        name = operator.name
        report = operator.report[Stage.OFFLINE]
        basis[name][WALK] = report[WALK]
        basis[name][FINAL] = report[FINAL]
        sigma[name][Treewalk.SPECTRUM_MU] = report[Treewalk.SPECTRUM_MU]
        energy[name][Treewalk.ENERGY_MU] = report[Treewalk.ENERGY_MU]
        errors_deim[name] = dict(operator.errors_rom)
        mu_space_deim[name] = operator.mu_space

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


class HyperReducedOrderModelMoving(HyperReducedOrderModelFixed):
    """The heat driver on the moving domain: adds the convection MDEIM
    (reference ``hrom.py:1369-1422``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.deim_moving_runned = False

    def _create_fom(self):
        fp = self.fom_params
        return HeatEquationMovingSolver(**self._fom_kwargs(), Lt=fp.get("Lt"),
                                        dLt_dt=fp.get("dLt_dt"))

    def _create_rom(self, fom, name="ROM"):
        return RomConstructorMoving(fom=fom, grid=self.grid, name=name,
                                    device=self.device)

    def setup_hyperreduction(self):
        super().setup_hyperreduction()
        self.mdeim_convection = MatrixDiscreteEmpiricalInterpolation(
            name=OperatorType.CONVECTION,
            assemble=self.fom.assemble_convection, grid=self.grid,
            tree_walk_params=self.mdeim_params)
        self.mdeim_convection.setup(rnd=self.rnd)

    def run_offline_hyperreduction(self, mu_space=None, evaluate=True):
        super().run_offline_hyperreduction(mu_space=mu_space,
                                           evaluate=evaluate)
        if self.models.get(OperatorType.CONVECTION):
            self._run_mdeim(object=self.mdeim_convection, mu_space=mu_space,
                            evaluate=evaluate, which=OperatorType.CONVECTION)
        self.deim_moving_runned = True

    def _resume_reductors(self):
        deims, operators = super()._resume_reductors()
        self.mdeim_convection.load_fom_basis()
        return (deims + [self.mdeim_convection],
                operators + [OperatorType.CONVECTION])


class HyperReducedPiston(HyperReducedOrderModelFixed):
    """The full nonlinear pipeline (reference ``hrom.py:1425-1650``): the
    base driver's machinery with the RHS-DEIM, the mass, stiffness,
    convection and nonlinear-lifting MDEIM and the trilinear N-MDEIM,
    the piston's reports and the μ-local fleet build."""

    def __init__(self, grid: dict, fom_params: dict, rom_params: dict,
                 deim_params: dict, mdeim_params: dict,
                 mdeim_nonlinear_params: dict = None, models: dict = None,
                 rnd=None, device="cuda") -> None:
        super().__init__(grid=grid, fom_params=fom_params,
                         rom_params=rom_params, deim_params=deim_params,
                         mdeim_params=mdeim_params, models=models, rnd=rnd,
                         device=device)
        self.mdeim_nonlinear_params = dict(mdeim_nonlinear_params or {})
        self.deim_moving_runned = False

    def dump_nonlinear_basis(self, path=None):
        dump_pickle(f"basis_fom_n-mdeim_{OperatorType.TRILINEAR}.pkl",
                    np.asarray(self.srom.basis_nonlinear))

    # ------------------------------------------------------------------
    # Setup (reference hrom.py:1452-1510)
    # ------------------------------------------------------------------
    def _create_fom(self):
        fp = self.fom_params
        return OneDimensionalBurgers(**self._fom_kwargs(), Lt=fp.get("Lt"),
                                     dLt_dt=fp.get("dLt_dt"))

    def _create_rom(self, fom, name="ROM"):
        return RomConstructorNonlinear(fom=fom, grid=self.grid, name=name,
                                       device=self.device)

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
        self.deim_runned = True

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
    # μ-local serving build (reference hrom.py:378-760)
    # ------------------------------------------------------------------
    def auto_cell_wn(self, candidates, target_floor, overlap=2, margin=1.0,
                     path=None, expect_n_cells=None, expect_edges=None):
        """Per-cell (W, N) from the persisted training trajectories
        (``StorageNames.MULOCAL_SNAPSHOTS``) by
        ``rom/windowed.py`` :func:`select_fleet_shapes` (reference
        ``hrom.py:378-436``). Raises ``FileNotFoundError`` without the
        cache and ``ValueError`` where it holds another number of cells
        than ``expect_n_cells`` or other edges than ``expect_edges``.
        Returns ``(cell_wn, floors)``."""
        from .windowed import select_fleet_shapes

        path = path or StorageNames.MULOCAL_SNAPSHOTS
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no μ-local snapshot cache at {path} — run "
                "build_mulocal_serving(snapshot_cache=True) first")
        cell_snapshots = []
        with np.load(path) as d:
            n_cells = len(d["per_cell"])
            if expect_n_cells is not None and n_cells != int(expect_n_cells):
                raise ValueError(
                    f"μ-local snapshot cache at {path} holds {n_cells} "
                    f"cells but the current build wants "
                    f"{int(expect_n_cells)} — delete the cache (it is from "
                    "a different partition) and rebuild")
            if expect_edges is not None:
                cached = np.asarray(d["edges"], np.float64)
                want = np.asarray(expect_edges, np.float64)
                if cached.shape != want.shape or not np.allclose(cached,
                                                                 want):
                    raise ValueError(
                        f"μ-local snapshot cache at {path} was built for "
                        f"cell edges {cached.tolist()} but the current "
                        f"build wants {want.tolist()} — delete the stale "
                        "cache and rebuild")
            for c in range(n_cells):
                cell_snapshots.append(
                    [np.asarray(d[f"snap_{c}_{j}"], np.float64)
                     for j in range(int(d["per_cell"][c]))])
        return select_fleet_shapes(cell_snapshots, candidates, target_floor,
                                   overlap=overlap, margin=margin)

    def _read_snapshot_cache(self, edges, wanted, local_tri, register,
                             device_sweep):
        """The cached per-cell trajectories, nonlinear rows and μ where the
        cache fits this build (reference ``hrom.py:590-633``): the same
        edges and per-cell counts, maximin sampling, nonlinear rows where
        the N-MDEIM is retrained, the μ where a cell registers, and a
        build precision that serves: an ``"f64"`` cache serves any build,
        a ``"device-f32"`` one only another device sweep, an untagged one
        none. None otherwise."""
        path = StorageNames.MULOCAL_SNAPSHOTS
        if not os.path.exists(path):
            return None
        n_cells = len(edges) - 1
        try:
            with np.load(path) as d:
                cached_build = str(d["build"]) if "build" in d else None
                want_build = "device-f32" if device_sweep else "f64"
                if not (cached_build in ("f64", want_build)
                        and d["edges"].shape == edges.shape
                        and np.allclose(d["edges"], edges)
                        and [int(x) for x in d["per_cell"]]
                        == [wanted[c] for c in range(n_cells)]
                        and (not local_tri or bool(d["has_nl"]))
                        and (not register or "mu_keys" in d)
                        and "sampling" in d
                        and str(d["sampling"]) == "maximin"):
                    return None
                mu_keys = ([str(k) for k in d["mu_keys"]]
                           if "mu_keys" in d else None)
                snaps, nls, mus = {}, {}, {}
                for c in range(n_cells):
                    snaps[c] = [np.asarray(d[f"snap_{c}_{j}"], np.float64)
                                for j in range(wanted[c])]
                    nls[c] = ([np.asarray(d[f"nl_{c}_{j}"], np.float64)
                               for j in range(wanted[c])]
                              if local_tri else [])
                    mus[c] = ([dict(zip(mu_keys, (float(x) for x in row)))
                               for row in d[f"mus_{c}"]]
                              if mu_keys is not None and f"mus_{c}" in d
                              else [])
                return snaps, nls, mus
        except (OSError, KeyError, ValueError, zipfile.BadZipFile):
            return None

    def _training_pool(self, edges, need, rnd):
        """Up to 8× each cell's count of candidate μ from the sampler,
        the pool regrown tenfold from an attempt-derived seed while a
        cell stays short (reference ``hrom.py:667-702``)."""
        from ..parameters import ParameterSampler

        n_cells = len(edges) - 1

        def cell_of(m):
            mach = self.rom.compute_piston_mach_number(m)
            return int(np.clip(np.searchsorted(edges, mach, side="right")
                               - 1, 0, n_cells - 1))

        oversample = 8
        cand = {c: [] for c in range(n_cells)}
        pool_size, attempts = int(2e4), 0
        pool = iter(ParameterSampler(self.grid, n_iter=pool_size,
                                     random_state=rnd))
        while any(len(cand[c]) < oversample * need[c]
                  for c in range(n_cells) if need[c]):
            try:
                m = dict(next(pool))
            except StopIteration:
                if all(len(cand[c]) >= need[c] for c in range(n_cells)):
                    break
                attempts += 1
                if attempts > 4:
                    empty = [c for c in range(n_cells)
                             if len(cand[c]) < need[c]]
                    raise ValueError(
                        f"could not fill Mach cells {empty} (edges "
                        f"{np.round(edges, 4).tolist()}) from the μ grid "
                        "— cells too narrow for the admissible range?")
                # Fresh draws from an attempt-derived seed: restarting
                # the same state would offer used candidates again.
                pool_size *= 10
                pool = iter(ParameterSampler(
                    self.grid, n_iter=pool_size,
                    random_state=np.random.RandomState(
                        rnd.randint(2**31 - 1))))
                continue
            c = cell_of(m)
            if need.get(c, 0) and len(cand[c]) < oversample * need[c]:
                cand[c].append(m)
        return cand

    def _maximin_subset(self, pool_c, k):
        """Greedy maximin in range-normalized μ, in numpy on the host,
        seeded at the candidate nearest the centroid (reference
        ``hrom.py:704-745``); a pool smaller than ``k`` is cycled."""
        spans = {}
        for key, dist in self.grid.items():
            sup = dist.support()
            span = float(max(sup)) - float(min(sup))
            # A point mass reports a NaN or zero span: unit, so it never
            # poisons the distances.
            spans[key] = span if np.isfinite(span) and span > 0 else 1.0
        X = np.array([[float(m[key]) / spans[key] for key in sorted(spans)]
                      for m in pool_c])
        X = np.where(np.isfinite(X), X, 0.0)
        picked = [int(np.argmin(np.linalg.norm(X - X.mean(axis=0), axis=1)))]
        dists = np.linalg.norm(X - X[picked[0]], axis=1)
        while len(picked) < min(k, len(pool_c)):
            dists[picked] = -1.0
            nxt = int(np.argmax(dists))
            picked.append(nxt)
            dists = np.minimum(dists, np.linalg.norm(X - X[nxt], axis=1))
        while len(picked) < k:
            picked.append(picked[len(picked) % len(pool_c)])
        return [pool_c[i] for i in picked]

    @offline
    def build_mulocal_serving(self, n_cells, n_windows, num_basis,
                              snapshots_per_cell=10, overlap=2, dump=True,
                              rnd=None, local_nmdeim=True,
                              augment_global=False, augment_weight=1.0,
                              srom_extra=None, edges=None,
                              device_sweep=False, mesh=None, cell_wn=None,
                              snapshot_cache=None, register=None):
        """The μ-local fleet (reference ``hrom.py:438-945``): K piston-Mach
        cells, each a windowed configuration built from trajectories of μ
        inside it, attached as ``rom.mulocal`` and dumped to
        ``StorageNames.WINDOWS_MULOCAL``.

        Per cell: ``snapshots_per_cell`` (an int or a list per cell)
        training μ, greedy maximin in range-normalized μ over up to 8× as
        many candidates from the sampler; their FOM trajectories, in
        float64 one ``fom.solve()`` each, or with ``device_sweep`` one
        ``solve_fom_batch`` of the whole fleet on the FOM's device (float32
        on the card, which tags the cache ``"device-f32"``; float64 on the
        CPU); the cell's trilinear N-MDEIM retrained on their nonlinear
        rows (``local_nmdeim``; on the serving copy ``rom.mdeim_Nh``,
        restored from its pickle in the working directory after); the
        window POD at the cell's (W, N) (``cell_wn``, else ``n_windows``,
        ``num_basis``) plus ``srom_extra`` modes, whose nested truncation
        serves while the enriched build is kept in ``cells_srom``.

        ``register`` (a list of cells, ``"all"`` or ``"auto"``): fit the
        cell's dilation law on its standard-clock trajectories
        (``rom/registration.py``) and re-solve them in float64 on their
        dilated grids (``T·d_j``, the same nt steps; a ``fom.solve()`` a
        μ, :meth:`_solve_registered_cell`); under ``"auto"`` a cell that
        does not phase-align builds unregistered.
        ``augment_global`` appends the retained box-wide trajectories
        (weighted) to every cell's stack; it refuses ``register``.
        ``snapshot_cache`` (default ``dump``) writes the trajectories to
        ``StorageNames.MULOCAL_SNAPSHOTS`` and reads them back where the
        edges, counts, sampling and precision fit. ``edges`` overrides the
        equal-width Mach edges over [PISTON_MACH_MIN, PISTON_MACH_MAX].
        With ``device_sweep``, a ``mesh`` of more than one shard shards
        the training sweep over it (``parallel.solve_fom_sharded``).
        ``fleet_seconds`` gets the seconds of each stage; ``cell_mus`` and
        ``cell_dilations`` each cell's training μ and registered training
        dilations."""
        from .pod import orth
        from .registration import fit_dilation_law
        from .windowed import MuLocalWindowed

        rom = self.rom
        rnd = rnd if rnd is not None else np.random.RandomState(0)
        if edges is not None:
            edges = np.asarray(edges, np.float64)
            n_cells = len(edges) - 1
        else:
            edges = rom.compute_piston_mach_number_space(
                self.grid, n_cells, mach_min=rom.PISTON_MACH_MIN,
                mach_max=rom.PISTON_MACH_MAX)

        fom = self.fom
        # The serving copy: add_hyper_reductor copies, so retraining the
        # driver's mdeim_trilinear would leave the serving tables as they
        # were.
        tri = rom.mdeim_Nh
        local_tri = (bool(local_nmdeim) and tri is not None
                     and self.mdeim_trilinear is not None)
        register_soft = register == "auto"
        if register in ("all", "auto"):
            register = set(range(n_cells))
        elif register:
            register = {int(c) for c in register}
        else:
            register = set()
        if register and augment_global:
            raise ValueError(
                "register + augment_global: box-wide augmentation "
                "trajectories live on the standard clock and cannot join a "
                "phase-aligned window stack")
        per_cell = (list(snapshots_per_cell) if np.ndim(snapshots_per_cell)
                    else [snapshots_per_cell] * n_cells)
        if len(per_cell) != n_cells:
            raise ValueError(f"snapshots_per_cell list ({len(per_cell)}) "
                             f"must match n_cells ({n_cells})")
        wn = (list(cell_wn) if cell_wn is not None
              else [(n_windows, num_basis)] * n_cells)
        if len(wn) != n_cells:
            raise ValueError(f"cell_wn ({len(wn)}) must match n_cells "
                             f"({n_cells})")
        wanted = {c: int(per_cell[c]) for c in range(n_cells)}
        if snapshot_cache is None:
            snapshot_cache = bool(dump)
        secs = dict.fromkeys(
            ("pool_maximin", "training_sweep", "snapshot_cache", "law_fit",
             "registered_resolves", "nmdeim_retrain", "window_pod",
             "window_projection", "dump"), 0.0)

        cached = (self._read_snapshot_cache(edges, wanted, local_tri,
                                            register, device_sweep)
                  if snapshot_cache else None)
        build_label = "f64"
        if cached is not None:
            cell_snaps, cell_nl, cell_mus = cached
        else:
            cell_snaps = {c: [] for c in range(n_cells)}
            cell_nl = {c: [] for c in range(n_cells)}
            t0 = time.perf_counter()
            cand = self._training_pool(edges, wanted, rnd)
            cell_mus = {}
            for c in range(n_cells):
                chosen = self._maximin_subset(cand[c], wanted[c])
                if (len(cand[c]) >= wanted[c]
                        and len({tuple(sorted(m.items()))
                                 for m in chosen}) < len(chosen)):
                    raise AssertionError(
                        f"cell {c}: duplicate training μ selected from "
                        f"{len(cand[c])} distinct candidates — maximin "
                        "selection degenerated")
                cell_mus[c] = [dict(m) for m in chosen]
            t1 = time.perf_counter()
            secs["pool_maximin"] = t1 - t0
            if device_sweep:
                build_label = self._sweep_fleet(cell_mus, cell_snaps,
                                                cell_nl, local_tri, mesh)
            else:
                for c in range(n_cells):
                    for m in cell_mus[c]:
                        fom.setup()
                        fom.update_parametrization(m)
                        fom.solve()
                        cell_snaps[c].append(np.asarray(
                            fom.solutions.snapshots, np.float64))
                        if local_tri:
                            cell_nl[c].append(list(fom.nonlinear_snapshots))
            secs["training_sweep"] = time.perf_counter() - t1
            if snapshot_cache:
                t0 = time.perf_counter()
                self._write_snapshot_cache(edges, per_cell, local_tri,
                                           build_label, cell_mus, cell_snaps,
                                           cell_nl)
                secs["snapshot_cache"] = time.perf_counter() - t0

        aug = []
        if augment_global:
            pool_snaps = self.srom.offline_snapshots
            m = (len(pool_snaps) if augment_global is True
                 else min(int(augment_global), len(pool_snaps)))
            # The retained trajectories are Mach-stratified: an even index
            # stride keeps the spread.
            idx = (np.unique(np.linspace(0, len(pool_snaps) - 1, m)
                             .round().astype(int)) if m else [])
            aug = [augment_weight * np.asarray(pool_snaps[i], np.float64)
                   for i in idx]

        keep_tri = self.rom_params.get(RomParameters.NMDEIM_SIZE)
        prev = rom.windows
        cells = []
        cells_srom = [] if srom_extra else None
        self.cell_mus = cell_mus
        self.cell_dilations = {}
        try:
            for c in range(n_cells):
                w_c, n_c = int(wn[c][0]), int(wn[c][1])
                snaps_c, nl_c, law = cell_snaps[c], cell_nl[c], None
                if c in register:
                    if len(cell_mus[c]) != len(snaps_c):
                        raise ValueError(
                            f"register cell {c}: training μ's are "
                            "unavailable (stale snapshot cache without mu "
                            f"payload?) — delete "
                            f"{StorageNames.MULOCAL_SNAPSHOTS} and rebuild")
                    t0 = time.perf_counter()
                    try:
                        law, dils = fit_dilation_law(snaps_c, cell_mus[c])
                    except ValueError:
                        if not register_soft:
                            raise
                        print(f"[register] cell {c}: no scalar phase "
                              "alignment — building unregistered",
                              file=sys.stderr, flush=True)
                    secs["law_fit"] += time.perf_counter() - t0
                    if law is not None:
                        t0 = time.perf_counter()
                        snaps_c, nl_c = self._solve_registered_cell(
                            cell_mus[c], dils, local_tri)
                        secs["registered_resolves"] += (
                            time.perf_counter() - t0)
                        self.cell_dilations[c] = np.asarray(dils)
                if local_tri:
                    # The σ-weighted hierarchical POD of the cell's
                    # nonlinear rows, as build_reduced_basis's.
                    t0 = time.perf_counter()
                    stages = []
                    for nl_rows in nl_c:
                        nl = np.array(nl_rows[1:], np.float64).T
                        b, s, _e = orth(nl)
                        stages.append(b * s[: b.shape[1]])
                    basis_nl, _s, _e = orth(np.hstack(stages),
                                            normalize=False)
                    tri.load_fom_basis(basis=basis_nl, keep=keep_tri)
                    rom._trilinear_table_cache = None
                    secs["nmdeim_retrain"] += time.perf_counter() - t0
                win = rom.build_windowed_serving(
                    n_windows=w_c, num_basis=n_c + (srom_extra or 0),
                    snapshots=snaps_c + aug, overlap=overlap)
                secs["window_pod"] += rom.build_seconds["window_pod"]
                secs["window_projection"] += (
                    rom.build_seconds["window_projection"])
                win.dilation = law
                if srom_extra:
                    cells_srom.append(win)
                    win = win.truncate(n_c)
                cells.append(win)
        finally:
            rom._set_serving_windows(prev)
            if local_tri:
                # The box-wide collateral basis from its pickle, projected
                # onto the global basis again.
                tri.load_fom_basis(keep=keep_tri)
                if rom.basis is not None:
                    tri.project_basis(V=rom.basis)
                rom._trilinear_table_cache = None

        ml = MuLocalWindowed(edges=np.asarray(edges), cells=cells,
                             cells_srom=cells_srom)
        rom.mulocal = ml
        if dump:
            t0 = time.perf_counter()
            ml.dump(StorageNames.WINDOWS_MULOCAL)
            secs["dump"] = time.perf_counter() - t0
        self.fleet_seconds = secs
        return ml

    def _solve_registered_cell(self, mus, dils, want_nl):
        """A registered cell's training μ re-solved each on its dilated
        grid (T·d_j, the same nt steps: the serving clock), a float64
        ``fom.solve()`` a μ (the native host loop where eligible), as the
        reference does (``hrom.py:947-975``). Returns the trajectories
        and, with ``want_nl``, their nonlinear rows."""
        fom = self.fom
        t_orig = fom.domain[fom.T]
        snaps, nls = [], []
        try:
            for m, d in zip(mus, dils):
                fom.domain[fom.T] = float(t_orig) * float(d)
                fom.setup()
                fom.update_parametrization(m)
                fom.solve()
                snaps.append(np.asarray(fom.solutions.snapshots, np.float64))
                if want_nl:
                    nls.append(list(fom.nonlinear_snapshots))
        finally:
            fom.domain[fom.T] = t_orig
        return snaps, nls

    def _sweep(self, mus, dtype, want_nl, mesh=None):
        """``mus`` in one ``solve_fom_batch`` on the FOM's device in
        ``dtype``, or in one ``solve_fom_sharded`` over ``mesh`` where it
        has more than one shard. Returns each μ's float64 trajectory (a
        ``dd_sweep`` FOM's low words recombined) and, with ``want_nl``,
        its nonlinear rows."""
        from ..parallel.sweep import solve_fom_batch, solve_fom_sharded

        fom = self.fom
        if fom.is_setup is False:
            fom.setup()
        with compute_dtype_scope(dtype):
            if mesh is not None and mesh.size > 1:
                outs = solve_fom_sharded(fom, mus, mesh=mesh)
            else:
                outs = solve_fom_batch(fom, mus)
        snaps, nls = [], []
        for b in range(len(mus)):
            uh = np.asarray(outs["uh"][b], np.float64).T
            if "uh_lo" in outs:
                uh = uh + np.asarray(outs["uh_lo"][b], np.float64).T
            snaps.append(uh)
            if want_nl:
                nls.append(np.asarray(outs["nonlinear_data"][b], np.float64))
        return snaps, nls

    def _sweep_fleet(self, cell_mus, cell_snaps, cell_nl, local_tri,
                     mesh=None):
        """Every cell's training μ in one :meth:`_sweep` (sharded over a
        ``mesh`` of more than one shard): float32 on the card, float64 on
        the CPU, as the FOM's device or the mesh's first device is. Fills
        ``cell_snaps`` and ``cell_nl``; returns the cache's build tag."""
        order = [(c, j) for c in sorted(cell_mus)
                 for j in range(len(cell_mus[c]))]
        home = (mesh.devices[0] if mesh is not None and mesh.size > 1
                else self.fom._compute_device())
        on_card = home.type != "cpu"
        snaps, nls = self._sweep([cell_mus[c][j] for c, j in order],
                                 torch.float32 if on_card else torch.float64,
                                 local_tri, mesh=mesh)
        for b, (c, _j) in enumerate(order):
            cell_snaps[c].append(snaps[b])
            if local_tri:
                cell_nl[c].append(nls[b])
        return "device-f32" if on_card else "f64"

    @staticmethod
    def _write_snapshot_cache(edges, per_cell, local_tri, build, cell_mus,
                              cell_snaps, cell_nl):
        """``StorageNames.MULOCAL_SNAPSHOTS`` with the reference's keys
        (``hrom.py:801-829``): edges, per-cell counts, ``has_nl``, the
        build precision, ``sampling``, ``mu_keys`` and ``mus_{c}``,
        ``snap_{c}_{j}`` and ``nl_{c}_{j}``."""
        n_cells = len(edges) - 1
        payload = {
            "edges": np.asarray(edges),
            "per_cell": np.asarray([int(per_cell[c])
                                    for c in range(n_cells)]),
            "has_nl": np.asarray(bool(local_tri)),
            "build": np.asarray(build),
            "sampling": np.asarray("maximin"),
        }
        if cell_mus[0]:
            mu_keys = sorted(cell_mus[0][0])
            payload["mu_keys"] = np.array(mu_keys)
            for c in range(n_cells):
                payload[f"mus_{c}"] = np.array(
                    [[float(m[k]) for k in mu_keys] for m in cell_mus[c]],
                    np.float64)
        for c in range(n_cells):
            for j, snap in enumerate(cell_snaps[c]):
                payload[f"snap_{c}_{j}"] = np.asarray(snap, np.float64)
            if local_tri:
                for j, rows in enumerate(cell_nl[c]):
                    payload[f"nl_{c}_{j}"] = np.asarray(rows, np.float64)
        np.savez(StorageNames.MULOCAL_SNAPSHOTS, **payload)

    # ------------------------------------------------------------------
    # Resume and evaluation (reference hrom.py:1571-1650)
    # ------------------------------------------------------------------
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

    def _postprocess_mu(self, which, idx_mu, mu, uh_fom):
        """The piston's reports of one evaluated μ (reference
        hrom.py:1588-1624): online, the FOM probes
        (``probes_<which>_fom_<idx>.csv``) and the FOM/ROM/S-ROM
        comparisons at the outflow and halfway
        (:meth:`save_fom_rom_probes`); always, the mass conservation of
        the ROM and of the FOM truth."""
        fom, rom, srom = self.fom, self.rom, self.srom
        n_tri = self.mdeim_trilinear.N
        if fom.RUNTIME_PROCESS and which == Stage.ONLINE:
            probes = fom.save_probes(name=f"probes_{which}_fom_{idx_mu}.csv")
            name = (f"probes_comparison_rom_{rom.N}_srom_{srom.N}_trilinear_"
                    f"{n_tri}_{which}_{idx_mu}.csv")
            self.save_fom_rom_probes(name=name,
                                     piston=np.asarray(probes["L"]),
                                     fom=fom, rom=rom, srom=srom)
        ts = rom.timesteps
        dump_csv(f"mass_conservation_rom_{rom.N}_srom_{srom.N}_mdeim_{n_tri}_"
                 f"{which}_rom_{idx_mu}.csv",
                 obj=fom.compute_mass_conservation(
                     mu=mu, ts=ts, solutions=rom.solutions.fom.T,
                     which=ProblemType.ROM))
        dump_csv(f"mass_conservation_{which}_fom_{idx_mu}.csv",
                 obj=fom.compute_mass_conservation(
                     mu=mu, ts=ts, solutions=np.asarray(uh_fom).T,
                     which=ProblemType.FOM))

    @staticmethod
    def compare_models(x, piston, ts, fom, rom, srom):
        """The FOM, ROM and S-ROM physical values at ``x`` over time and
        the piston's position, as the reference's table (hrom.py:1626-1637):
        a dict of its columns ``fom``, ``rom``, ``srom``, ``piston`` and
        its index (``"index"``, the times)."""
        return {"index": np.asarray(ts),
                ProblemType.FOM: fom.solutions.compute_at(x=x),
                ProblemType.ROM: rom.solutions.compute_at(x=x),
                ProblemType.SROM: srom.solutions.compute_at(x=x),
                ProbeLocations.PISTON: np.asarray(piston)}

    def save_fom_rom_probes(self, name, piston, fom, rom, srom):
        """:meth:`compare_models` at the outflow (x=0) and halfway
        (x=0.5), written as ``outflow_<name>`` and ``halfway_<name>``
        (reference hrom.py:1639-1650)."""
        ts = rom.solutions.ts
        outflow = self.compare_models(0.0, piston, ts, fom, rom, srom)
        half = self.compare_models(0.5, piston, ts, fom, rom, srom)
        for loc, table in ((ProbeLocations.OUTFLOW, outflow),
                           (ProbeLocations.MIDDLE, half)):
            _write_indexed("_".join([loc, name]), table)
        return outflow, half

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
