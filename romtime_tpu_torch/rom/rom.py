"""The reduced-order models (counterpart of ``romtime_tpu/rom/rom.py``):
:class:`RomConstructor`, the base (fixed-domain heat) family,
:class:`RomConstructorMoving`, which adds the ALE convection, and
:class:`RomConstructorNonlinear`, the piston ROM, which adds the
nonlinear lifting and the trilinear term. Each family has its own θ
sources (``SOURCES``), its own reduced-assembly fallbacks
(``FALLBACKS``: the base family's right-hand side is forcing plus
lifting, the piston's the lifting alone) and its own system parts.

**Build** (the reference's form ``RomConstructorNonlinear(fom=…,
grid=…, name=…)``, ``device`` the card unless the caller says
otherwise): ``setup(rnd)``, then ``build_reduced_basis`` (the FOM sweep
per μ, serially through ``fom.solve()`` or as one batch through
``parallel.solve_fom_batch`` with ``device_sweep=True``, then the
σ-weighted hierarchical POD on the host in float64, and the nonlinear
basis of the FOM-captured trilinear snapshots), ``truncate`` (S-ROM →
ROM), ``add_hyper_reductor`` and ``project_reductors``; the
Mach-stratified sampler; the trilinear state table
(``_trilinear_state_table``: the scale-invariance probe, then the exact
N-column table, or the N-MDEIM reconstruction under
``ROMTIME_TRI_TABLE=deim``). A projected ROM serves its own
:class:`~romtime_tpu_torch.rom.engines.global_fused.GlobalServing`
(``global_serving``, made at first use). The offline methods run in
float64 (``deim.deim.OFFLINE_DTYPE``) whatever the serving dtype.

**Online, one μ** (``solve``, reference ``rom.py:1139-1166``): the
BDF-1/2 loop of ``_online_scan`` in eager torch on the ROM's device, θ
of every trained reductor over the whole time grid hoisted out of it,
each operator without a reductor projected from the FOM's assembly
(``assemble_*``, on the device), the trilinear term from the exact state
table; the double-word residual step in float32 (``COMPENSATED``), the
plain step in float64. The same loop over a μ batch in the last axis is
the ``"vmap"`` engine, which ``solve_batch`` takes where an operator has
no reductor (``_lanes_supported``).

**Serving** ``solve_batch`` with ``mode="probes"`` on windowed serving
(the ``"windowed-pallas"`` engine) and on the global basis (the
``"pallas"`` engine), behind the reference's pivot-free guard
``certify_pivot_free``; the global lanes engine ``"lanes"`` and the
windowed lanes engine ``"windowed"`` in every mode, float64 or float32;
a μ-local fleet routed by Mach cell, ``solve_batch_mulocal``. A serving
object also comes from artifacts (:meth:`RomConstructorNonlinear
.from_artifacts`: a FOM, serving reductors and the windows and/or the
global configuration), as ``convert`` and ``testing.synthetic`` make
them.
"""

import os
import time
from copy import deepcopy

import numpy as np
import torch

from ..base import RomSolutionsStorage
from ..conventions import (
    BDF,
    OperatorType,
    PistonParameters,
    RomParameters,
    Stage,
    StorageNames,
    Treewalk,
    TreewalkNonlinear,
)
from ..deim import (
    DiscreteEmpiricalInterpolation,
    MatrixDiscreteEmpiricalInterpolation,
)
from ..deim.deim import offline
from ..deim.mdeim import project_band
from ..dtypes import asarray, compute_dtype, compute_dtype_scope
from ..ops.linalg import gauss_solve_lanes
from ..ops.windowed_fused import _no_tf32
from ..parameters import ParameterSampler
from ..utils.progress import progress
from .base import Reductor
from .pod import orth
from .engines.autotune import AutotuneMixin
from .engines.mulocal import MuLocalRoutingMixin
from .engines.global_fused import (
    GlobalServing,
    global_prep,
    global_sweep,
    global_tables,
    supported,
)
from .engines.global_lanes import (
    global_lanes_tables,
    online_scan_batch,
    theta_tables,
)
from .engines.policy import PrecomputePolicy, SolvePolicy, box_corners
from .engines.windowed_fused import (
    RHS,
    time_grid,
    windowed_prep,
    windowed_sweep,
    windowed_tables,
    stiffness_side,
)
from .engines.windowed_lanes import (
    MODES,
    dd_correct,
    dd_predict,
    online_sweep_windowed,
    output_dofs,
    stack_outputs,
    step_outputs,
    windowed_lanes_tables,
)

#: θ source name → (reductor class, FOM assembly method), in the
#: reference's ``_theta_sources`` order (rom.py:525, :1277, :1421), which
#: fixes the stiffness-side row order of the θ tables. Every family's
#: sources are the leading ones of this order (``SOURCES``).
THETA_SOURCES = {
    "mass": (MatrixDiscreteEmpiricalInterpolation, "assemble_mass"),
    "stiffness": (MatrixDiscreteEmpiricalInterpolation,
                  "assemble_stiffness"),
    "rhs_vec": (DiscreteEmpiricalInterpolation, "assemble_rhs"),
    "convection": (MatrixDiscreteEmpiricalInterpolation,
                   "assemble_convection"),
    "nonlinear_lifting": (MatrixDiscreteEmpiricalInterpolation,
                          "assemble_nonlinear_lifting"),
}

#: θ source name → the reference's reductor attribute.
SOURCE_ATTRS = {"mass": "mdeim_Mh", "stiffness": "mdeim_Ah",
                "rhs_vec": "deim_rhs", "convection": "mdeim_Ch",
                "nonlinear_lifting": "mdeim_Nh_hat"}

#: θ source name → the reduced assembly that stands in for its reductor
#: where none is attached, the piston's (reference ``rom.py:1421-1427``):
#: the FOM operator projected onto the basis. The base family's
#: right-hand side is ``assemble_rhs`` (``:525-534``).
FALLBACKS = {"mass": "assemble_mass", "stiffness": "assemble_stiffness",
             "rhs_vec": "assemble_lifting",
             "convection": "assemble_convection",
             "nonlinear_lifting": "assemble_nonlinear_lifting"}

#: ``add_hyper_reductor``'s operator tags → reductor attribute
#: (reference ``rom.py:218-242``).
REDUCTOR_ATTRS = {
    OperatorType.RHS: "deim_rhs",
    OperatorType.MASS: "mdeim_Mh",
    OperatorType.STIFFNESS: "mdeim_Ah",
    OperatorType.CONVECTION: "mdeim_Ch",
    OperatorType.TRILINEAR: "mdeim_Nh",
    OperatorType.NONLINEAR_LIFTING: "mdeim_Nh_hat",
}


def make_reductors(fom, dofs, reduced=None):
    """Serving reductors bound to ``fom`` from per-source dofs (the
    sources ``dofs`` names, in :data:`THETA_SOURCES` order); ``reduced``
    maps a source name to its optional ``PT_U`` and ``basis_rom`` (the
    global basis's float64 θ-solve)."""
    reduced = reduced or {}
    return {
        name: cls(assemble=getattr(fom, method), dofs=dofs[name], name=name,
                  **reduced.get(name, {}))
        for name, (cls, method) in THETA_SOURCES.items() if name in dofs
    }


def grid_box(grid):
    """The μ box, name → (lo, hi), of a grid of distributions (each
    ``support()``), of (lo, hi) pairs or of value lists; None for None."""
    if grid is None:
        return None
    box = {}
    for k, v in grid.items():
        values = v.support() if hasattr(v, "support") else v
        box[k] = (float(min(values)), float(max(values)))
    return box


def sampling_box(grid):
    """The box, name → (lo, hi), that a sampler over ``grid`` draws from:
    a frozen uniform's loc and loc + scale (a fixed parameter's too, whose
    ``support()`` scipy gives as nan), a (lo, hi) pair or a value list's
    extremes as they are; None for None."""
    if grid is None:
        return None
    box = {}
    for k, v in grid.items():
        kwds = getattr(v, "kwds", None)
        if kwds is not None:
            loc = float(kwds.get("loc", 0.0))
            box[k] = (loc, loc + float(kwds.get("scale", 1.0)))
        else:
            box[k] = (float(min(v)), float(max(v)))
    return box


class RomConstructor(AutotuneMixin, PrecomputePolicy, SolvePolicy,
                     Reductor):
    """The base (fixed-domain heat) ROM on one device (the card unless
    ``device`` says otherwise; reference ``rom.py:75-1267``).

    The reductors sit in the reference's attributes (``mdeim_Mh``,
    ``mdeim_Ah``, ``deim_rhs``, and in the subclasses ``mdeim_Ch``,
    ``mdeim_Nh_hat``, ``mdeim_Nh``); :attr:`reductors` maps every θ
    source name of the family's ``SOURCES`` to its reductor. ``windows``
    is the active :class:`~romtime_tpu_torch.rom.windowed.WindowedServing`
    and ``global_serving`` the global-basis
    :class:`~romtime_tpu_torch.rom.engines.global_fused.GlobalServing`:
    one of them, or both (windows then serve by default, as in the
    reference, and the global basis carries the pivot-free guard).
    ``grid`` is the μ box, name → (lo, hi), that the guard and the auto
    solve policy probe (``sampling_grid`` the distributions the build
    samples)."""

    #: θ sources of the family, in the reference's order.
    SOURCES = ("mass", "stiffness", "rhs_vec")
    #: θ source → its reduced-assembly fallback (reference rom.py:525-534).
    FALLBACKS = {"mass": "assemble_mass", "stiffness": "assemble_stiffness",
                 "rhs_vec": "assemble_rhs"}
    #: Whether the family has a state-dependent (trilinear) term, which the
    #: global kernels and the global lanes engine serve only from the
    #: trilinear state table.
    STATE_DEPENDENT = False

    # The online engines eliminate without pivoting, justified by the
    # M-dominance of K_N = bdf·M_N + dt·S_N; the certifiable proxy is
    # cond₂(K_N) ≤ PIVOT_FREE_COND_BOUND over the μ box (reference
    # rom.py:842-859). "auto": certify once per instance; "off": skip.
    PIVOT_FREE_COND_BOUND = 1e4
    PIVOT_GUARD = "auto"

    # The residual-form double-word step is a precision tool for float32
    # serving: "auto" takes it in float32 and the plain step in float64
    # (reference rom.py:518-523, engines/policy.py:62); True or False
    # forces it. Read by ``_online_scan`` and the global lanes engine.
    COMPENSATED = "auto"


    def __init__(self, fom, grid=None, name=None, device="cuda"):
        """The reference's form: ``grid`` maps μ names to distributions
        (the sampler draws from them; a (lo, hi) box serves the guard and
        the policy only)."""
        Reductor.__init__(self, grid=grid)
        self.sampling_grid = grid
        self.grid = grid_box(grid)
        self.fom = fom
        self.name = name
        self.device = torch.device(device)

        self.basis = None
        self.basis_nonlinear = None
        self.offline_snapshots = []
        # Precision of the retained snapshots ("f64" / "device-f32").
        self.offline_snapshots_build = None
        # Seconds of the last build's stages ("fom_sweep", "pod").
        self.build_seconds = {}

        for attr in REDUCTOR_ATTRS.values():
            setattr(self, attr, None)

        self.windows = None
        self.mulocal = None
        self._global_serving = None
        self._projected = False
        self._global_tables = None
        self._pivot_cert = None
        self._trilinear_table_cache = None
        self._device_cache = {}

        # The last single-μ solution (``solve``) and, where the FOM has an
        # exact solution, each solved μ's error series.
        self.solutions = dict()
        self.errors = dict()
        self.exact = dict()

    @classmethod
    def from_artifacts(cls, fom, reductors, windows=None, device="cuda",
                       global_serving=None, grid=None):
        """A serving object from built artifacts: ``reductors`` maps every
        θ source name of the family's ``SOURCES`` to a serving reductor bound
        to ``fom``, ``windows`` and/or ``global_serving`` what it serves,
        ``grid`` the μ box (name → (lo, hi))."""
        missing = set(cls.SOURCES) - set(reductors)
        if missing:
            raise ValueError(f"missing θ sources: {sorted(missing)}")
        if windows is None and global_serving is None:
            raise ValueError("a serving object needs windows or a global "
                             "serving configuration")
        rom = cls(fom, grid=grid, device=device)
        for name in cls.SOURCES:
            setattr(rom, SOURCE_ATTRS[name], reductors[name])
        rom.global_serving = global_serving
        if global_serving is not None:
            rom.basis = np.asarray(global_serving.basis)
        rom._set_serving_windows(windows)
        return rom

    @property
    def reductors(self):
        """θ source name → reductor, in the reference's source order."""
        return {name: getattr(self, SOURCE_ATTRS[name])
                for name in self.SOURCES}

    @property
    def global_serving(self):
        """The global configuration: the one attached, or, on a built and
        projected ROM, its own (:meth:`GlobalServing.from_rom`, made at
        first use and kept until the next projection)."""
        if self._global_serving is None and self._projected:
            self._global_serving = GlobalServing.from_rom(self)
        return self._global_serving

    @global_serving.setter
    def global_serving(self, gs):
        self._global_serving = gs
        self._global_tables = None

    @property
    def N(self):
        """The basis's N (reference rom.py:145-147); a windowed
        configuration's is ``windows.N``."""
        return self.basis.shape[1]

    @property
    def timesteps(self):
        """The times of the last single-μ solution."""
        return self.solutions.ts

    def _theta_sources(self):
        """name → reductor, in the reference's source order."""
        return self.reductors

    def _reduction_sources(self):
        """name → (reductor or None, its reduced-assembly fallback), the
        reference's ``_theta_sources`` (rom.py:525-534, :1277-1280,
        :1421-1427): the single-μ loop and the eager assembly API read the
        fallback where no reductor is attached."""
        return {name: (red, getattr(self, self.FALLBACKS[name]))
                for name, red in self.reductors.items()}

    # ------------------------------------------------------------------
    # Projections (reference rom.py:158-176)
    # ------------------------------------------------------------------
    def to_fom_vector(self, uN):
        """u_h = V u_N (numpy)."""
        return np.asarray(self.basis) @ np.asarray(uN)

    def to_rom_vector(self, uh):
        """u_N = Vᵀ u_h (numpy)."""
        return np.asarray(self.basis).T @ np.asarray(uh)

    def _on_device(self, key, array, like):
        """``array`` (numpy) as a tensor of ``like``'s dtype and device,
        kept while ``array`` is the same object."""
        key = (key, like.dtype, str(like.device))
        hit = self._device_cache.get(key)
        if hit is None or hit[0] is not array:
            hit = self._device_cache[key] = (array, torch.as_tensor(
                np.asarray(array), dtype=like.dtype, device=like.device))
        return hit[1]

    def to_rom(self, oph):
        """Vᵀ·A·V of a banded FOM operator (2p+1, nh, …) as (N, N, …), or
        Vᵀ·f of a vector (nh, …) as (N, …): on the operator's device in
        its dtype (the reference projects in the compute dtype,
        rom.py:168-174), its batch axes trailing."""
        if hasattr(oph, "band"):
            band = oph.band
            V = self._on_device("basis", self.basis, band)
            p, nh, N = (band.shape[0] - 1) // 2, band.shape[1], V.shape[1]
            flat = band.reshape(band.shape[0], nh, -1)
            Vpad = torch.nn.functional.pad(V, (0, 0, p, p))
            AV = sum(flat[d][:, None, :] * Vpad[d:d + nh][:, :, None]
                     for d in range(2 * p + 1))               # (nh, N, K)
            return (V.T @ AV.reshape(nh, -1)).reshape(
                (N, N) + tuple(band.shape[2:]))
        f = torch.as_tensor(oph)
        V = self._on_device("basis", self.basis, f)
        return (V.T @ f.reshape(f.shape[0], -1)).reshape(
            (V.shape[1],) + tuple(f.shape[1:]))

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------
    def load_from_basis(self, basis, mu_space):
        """Adopt an externally built basis (the resume path; reference
        rom.py:190-198)."""
        self.basis = deepcopy(np.asarray(basis))
        mu_space = deepcopy(mu_space)
        mu_space[Stage.ONLINE] = []
        mu_space[Stage.VALIDATION] = []
        self.mu_space = mu_space
        self._reset_serving()

    def truncate(self, n):
        """Drop ``n`` modes: the S-ROM → ROM path (reference
        rom.py:200-216). The reductors are not carried over."""
        truncated = self.__class__(fom=self.fom, grid=self.sampling_grid,
                                   name=self.name, device=self.device)
        truncated.setup(rnd=self.random_state)
        N = self.N
        assert n < N, ("You want to remove too many modes from S-ROM to "
                       "create ROM.")
        truncated.basis = self.basis[:, : N - n]
        truncated.mu_space = deepcopy(self.mu_space)
        truncated.report = deepcopy(self.report)
        truncated.report[Stage.OFFLINE][Treewalk.BASIS_FINAL] = truncated.N
        return truncated

    def _reset_serving(self):
        """Drop what the serving derived from the reductors and the basis
        (the global configuration, its tables, the pivot certificate)."""
        self._global_serving = None
        self._projected = False
        self._global_tables = None
        self._pivot_cert = None

    # ------------------------------------------------------------------
    # Hyper-reduction plumbing
    # ------------------------------------------------------------------
    def add_hyper_reductor(self, reductor, which):
        """Attach a copy of a trained (M)DEIM reductor for an operator
        (reference rom.py:218-242)."""
        attr = REDUCTOR_ATTRS.get(which)
        if attr is None:
            raise NotImplementedError(f"Which is this reductor? {which}")
        setattr(self, attr, reductor.copy())
        self._reset_serving()

    def project_reductors(self):
        """Project every collateral basis onto the solution basis
        (reference rom.py:244-266). The reprojected operators form a new
        reduced family: the global configuration is made anew at its
        next use and the pivot-free bound re-certified before the next
        serve."""
        for attr in REDUCTOR_ATTRS.values():
            red = getattr(self, attr)
            if red:
                red.project_basis(V=self.basis)
        self._reset_serving()
        self._projected = all(getattr(self, attr) is not None
                              for attr in self._serving_attrs())

    def _serving_attrs(self):
        """The reductor attributes a global configuration needs: every θ
        source's."""
        return [SOURCE_ATTRS[name] for name in self.SOURCES]

    # ------------------------------------------------------------------
    # Offline: reduced-basis construction
    # ------------------------------------------------------------------
    @offline
    def build_reduced_basis(self, num_snapshots=None, mu_space=None,
                            num_basis=None, tolerances=dict(),
                            device_sweep=False, mesh=None):
        """The FOM sweep per μ and the POD tree walk, with the nonlinear
        basis of the FOM-captured trilinear snapshots (reference
        rom.py:336-505). Serially (``fom.solve()`` per μ on the FOM's
        device, each μ's probe CSV written under ``RUNTIME_PROCESS``), or
        with ``device_sweep=True`` as one ``solve_fom_batch`` of the
        whole μ list (a ``dd_sweep`` FOM's low words recombined in
        float64). A ``mesh`` of more than one shard
        (:class:`~romtime_tpu_torch.parallel.mesh.DeviceMesh`) takes
        ``solve_fom_sharded`` over it instead. Both keep
        ``offline_snapshots`` and the σ-weighted hierarchical POD
        (float64, on the host)."""
        if mu_space:
            space = mu_space
        elif num_snapshots:
            space = self.build_sampling_space(num=num_snapshots,
                                              rnd=self.random_state)
        else:
            raise NotImplementedError(
                "You need to provide a number of mu-snapshots or a space.")

        fom = self.fom
        if fom.is_setup is False:
            fom.setup()
        collect_nonlinear = hasattr(fom, "nonlinear_snapshots")

        fom_solutions = dict()
        basis_time = []
        basis_nonlinear = []
        tol_t = tolerances.get(RomParameters.TOL_TIME, None)
        offline_report = self.report[Stage.OFFLINE]
        pod_seconds = [0.0]

        def ingest(mu_idx, snapshots, uc, nl_rows):
            """Per-μ POD stages on host-side float64 data."""
            t0 = time.perf_counter()
            fom_solutions[mu_idx] = uc
            self.offline_snapshots.append(np.asarray(snapshots).copy())
            # Stage-1 modes scaled by their σ (hierarchical weighting).
            _basis, sigmas_time, energy_time = orth(snapshots, tol=tol_t)
            basis_time.append(_basis * sigmas_time[: _basis.shape[1]])
            offline_report[Treewalk.SPECTRUM_TIME][mu_idx] = sigmas_time
            offline_report[Treewalk.ENERGY_TIME][mu_idx] = energy_time
            offline_report[Treewalk.BASIS_TIME][mu_idx] = _basis.shape[1]
            if collect_nonlinear:
                # The first snapshot dropped: zero initial state.
                nl = np.array(nl_rows[1:]).T
                _basis_nl, _sigmas_nl, _energy_nl = orth(nl, tol=tol_t)
                basis_nonlinear.append(
                    _basis_nl * _sigmas_nl[: _basis_nl.shape[1]])
                offline_report[TreewalkNonlinear.SPECTRUM_TIME][mu_idx] = (
                    _sigmas_nl)
                offline_report[TreewalkNonlinear.ENERGY_TIME][mu_idx] = (
                    _energy_nl)
                offline_report[TreewalkNonlinear.BASIS_TIME][mu_idx] = (
                    _basis_nl.shape[1])
            pod_seconds[0] += time.perf_counter() - t0

        t_start = time.perf_counter()
        if device_sweep:
            from ..parallel.sweep import solve_fom_batch, solve_fom_sharded

            self.offline_snapshots_build = (
                "f64" if compute_dtype() == torch.float64 else "device-f32")
            registered = [self.add_mu(mu=mu, step=Stage.OFFLINE)
                          for mu in space]
            mus = [mu for _i, mu in registered]
            if mesh is not None and mesh.size > 1:
                outs = solve_fom_sharded(fom, mus, mesh=mesh)
            else:
                outs = solve_fom_batch(fom, mus)
            t_sweep = time.perf_counter() - t_start
            for b, (mu_idx, _mu) in enumerate(registered):
                uh = np.asarray(outs["uh"][b], np.float64).T
                uc = np.asarray(outs["uc"][b], np.float64).T
                if "uh_lo" in outs:
                    lo = np.asarray(outs["uh_lo"][b], np.float64).T
                    uh = uh + lo
                    uc = uc + lo
                ingest(mu_idx, uh, uc,
                       np.asarray(outs["nonlinear_data"][b], np.float64)
                       if collect_nonlinear else None)
        else:
            self.offline_snapshots_build = "f64"
            for mu in progress(space, label="offline FOM sweep"):
                mu_idx, mu = self.add_mu(mu=mu, step=Stage.OFFLINE)
                fom.setup()
                fom.update_parametrization(mu)
                fom.solve()
                ingest(mu_idx, np.asarray(fom.solutions.snapshots),
                       fom.solutions.fom.copy(),
                       list(fom.nonlinear_snapshots)
                       if collect_nonlinear else None)
                if fom.RUNTIME_PROCESS and hasattr(fom, "save_probes"):
                    fom.save_probes(name=f"probes_offline_fom_{mu_idx}.csv")
            t_sweep = time.perf_counter() - t_start - pod_seconds[0]

        t0 = time.perf_counter()
        basis = np.hstack(basis_time)
        offline_report[Treewalk.BASIS_AFTER_WALK] = basis.shape[1]
        basis, sigmas_mu, energy_mu = orth(
            basis, num=num_basis, tol=tolerances.get(RomParameters.TOL_MU),
            normalize=False)
        offline_report[Treewalk.SPECTRUM_MU] = sigmas_mu
        offline_report[Treewalk.ENERGY_MU] = energy_mu
        offline_report[Treewalk.BASIS_FINAL] = basis.shape[1]
        self.basis = basis

        if collect_nonlinear and basis_nonlinear:
            basis_nonlinear = np.hstack(basis_nonlinear)
            offline_report[TreewalkNonlinear.BASIS_AFTER_WALK] = (
                basis_nonlinear.shape[1])
            basis_nonlinear, sigmas_nl, energy_nl = orth(basis_nonlinear,
                                                         normalize=False)
            offline_report[TreewalkNonlinear.SPECTRUM_MU] = sigmas_nl
            offline_report[TreewalkNonlinear.ENERGY_MU] = energy_nl
            offline_report[TreewalkNonlinear.BASIS_FINAL] = (
                basis_nonlinear.shape[1])
            self.basis_nonlinear = basis_nonlinear
        self.build_seconds = {
            "fom_sweep": t_sweep,
            "pod": pod_seconds[0] + time.perf_counter() - t0}

        assert self.N != 0, "(ROM) There are no basis vectors."
        self._reset_serving()
        return fom_solutions

    def build_sampling_space(self, num, rnd=None):
        """``num`` random μ from the sampling distributions (reference
        ``rom/base.py:98-120``; ``grid`` here is their (lo, hi) box)."""
        return ParameterSampler(param_distributions=self.sampling_grid,
                                n_iter=num, random_state=rnd)

    # ------------------------------------------------------------------
    # The trilinear state table: the nonlinear family's
    # ------------------------------------------------------------------
    def _trilinear_state_table(self, V_np):
        """None: the family has no state-dependent term."""
        return None

    # ------------------------------------------------------------------
    # Reduced operators (reference rom.py:268-331, :1273-1275,
    # :1384-1427): the reductor's interpolation where one is attached,
    # else the FOM operator projected onto the basis (``to_rom``). μ and t
    # are numbers or tensors; the results are tensors on the ROM's device
    # in the compute dtype, their batch axes trailing.
    # ------------------------------------------------------------------
    def _reduced_args(self, mu, t):
        """μ and t as tensors in the compute dtype on the ROM's device
        (tensors pass through)."""
        dtype = compute_dtype()

        def tensor(v):
            if torch.is_tensor(v):
                return v
            return torch.tensor(float(v), dtype=dtype, device=self.device)

        return {k: tensor(v) for k, v in mu.items()}, tensor(t)

    def _reduced_matrix(self, mdeim, fom_assemble, mu, t, u_n=None):
        mu, t = self._reduced_args(mu, t)
        if mdeim is not None:
            state = () if u_n is None else (u_n,)
            values = mdeim._interpolate_traced(mu, t, *state,
                                               which=mdeim.ROM)
            return values.reshape((self.N, self.N) + tuple(values.shape[1:]))
        if u_n is None:
            return self.to_rom(fom_assemble(mu, t))
        return self.to_rom(fom_assemble(mu=mu, t=t, u_n=u_n))

    def _reduced_vector(self, deim, fom_assemble, mu, t):
        mu, t = self._reduced_args(mu, t)
        if deim is not None:
            return deim._interpolate_traced(mu, t, which=deim.ROM)
        return self.to_rom(fom_assemble(mu, t))

    def assemble_mass(self, mu, t):
        return self._reduced_matrix(self.mdeim_Mh, self.fom.assemble_mass,
                                    mu, t)

    def assemble_stiffness(self, mu, t):
        return self._reduced_matrix(self.mdeim_Ah,
                                    self.fom.assemble_stiffness, mu, t)

    def assemble_forcing(self, mu, t):
        return self._reduced_vector(None, self.fom.assemble_forcing, mu, t)

    def assemble_lifting(self, mu, t):
        """The lifting vector, projected (reference rom.py:306-307)."""
        return self._reduced_vector(None, self.fom.assemble_lifting, mu, t)

    def assemble_rhs(self, mu, t):
        """Forcing + lifting (reference rom.py:295-301)."""
        if self.deim_rhs is not None:
            return self._reduced_vector(self.deim_rhs, None, mu, t)
        return self.assemble_forcing(mu, t) + self.assemble_lifting(mu, t)

    def assemble_system(self, mu, t, bdf=1.0, uh=None, uh_n1=None):
        """(M_N, K_N = bdf·M_N + dt·S_N) through :meth:`_system_matrices`
        with the eager reduced assembly (reference rom.py:309-323)."""
        sources = self._reduction_sources()

        def get(name):
            return sources[name][1](mu=mu, t=t)

        return self._system_matrices(get, mu, t, bdf, uh, uh_n1)

    def assemble_system_rhs(self, mu, t, MN_mat, uN_n, uN_n1=None):
        """b_N = M_N·(2u_N − ½u_N₋₁) + dt·f_N, or M_N·u_N + dt·f_N without
        a history, f_N the forcing plus the lifting (reference
        rom.py:325-331)."""
        fN = self.assemble_rhs(mu=mu, t=t)
        if uN_n1 is None:
            bdf_term = MN_mat @ uN_n
        else:
            bdf_term = MN_mat @ (2.0 * uN_n - 0.5 * uN_n1)
        return bdf_term + self.fom.dt * fN

    # ------------------------------------------------------------------
    # The step's parts (reference rom.py:510-549, :1395-1403, :1589-1634)
    # ------------------------------------------------------------------
    def runtime_process(self, u=None, mu=None, t=None):
        pass

    def _state_representation(self, V, uN):
        """How the state enters the reduced operators: a linear family's
        ignore it (reference rom.py:513-516)."""
        return None

    def _compensated_active(self):
        """The residual-form double-word step: on in float32 under
        ``COMPENSATED = "auto"``, else as forced."""
        if self.COMPENSATED == "auto":
            return compute_dtype() == torch.float32
        return bool(self.COMPENSATED)

    def _system_parts(self, get, mu, t, uh, uh_n1):
        """(M_N, dt·A_N) from the per-step operator getter, kept apart so
        that the residual-form step never forms S from K − bdf·M
        (reference rom.py:536-543)."""
        MN = get("mass")
        AN = get("stiffness")
        return MN, self.fom.dt * AN

    def _system_matrices(self, get, mu, t, bdf, uh, uh_n1):
        """(M_N, K_N = bdf·M_N + dt·S_N)."""
        MN, dtS = self._system_parts(get, mu, t, uh, uh_n1)
        return MN, bdf * MN + dtS

    # ------------------------------------------------------------------
    # Online: the single-μ loop, and the same loop over a μ batch (the
    # "vmap" engine); reference rom.py:550-679, :1139-1166
    # ------------------------------------------------------------------
    def _lanes_supported(self):
        """The lanes engines need every operator hyper-reduced (reference
        rom.py:1051-1061)."""
        return all(red is not None for red in self.reductors.values())

    def _online_scan(self, mu, mode="full"):
        """The reduced BDF-1/2 loop over the whole time grid for ``mu``
        (name → (B,) tensors on the ROM's device, whose dtype is the
        loop's), eager torch, the μ batch in the last axis: θ of every
        attached reductor over the grid hoisted out of the loop, the
        other operators assembled and projected at each step; the
        residual-form double-word step where :meth:`_compensated_active`,
        else the plain BDF step; the lifting on the moving domain. The BDF
        branch and every scalar are fixed before the loop, which reads
        nothing back from the device.

        Returns (nt, …, B) tensors by mode, as the lanes engines: ``t``
        (nt,) and ``uN`` (nt, N, B) and, by mode, ``uc`` and ``x``
        (nt, nh, B) and, where the FOM has an exact solution, ``error``
        (nt, B) ("full"); ``probes`` (nt, 2, B) ("reduced", "probes");
        ``uN_final`` (N, B) without ``uN`` ("probes")."""
        fom = self.fom
        ref = next(iter(mu.values()))
        dtype, device, B = ref.dtype, ref.device, ref.shape[0]
        if device.type == "cuda":
            _no_tf32()
        nt = int(fom.domain[fom.NT])
        bdf2 = fom.BDF_SCHEME == BDF.TWO
        V = self._on_device("basis", self.basis, ref)
        N = V.shape[1]
        dt = torch.tensor(float(fom.dt), dtype=dtype, device=device)
        ts = time_grid(fom, None, dtype, device)
        sources = self._reduction_sources()
        trained = {name: red for name, (red, _fb) in sources.items()
                   if red is not None}
        thetas = theta_tables(trained, mu, ts) if trained else {}
        combines = {name: torch.as_tensor(
            np.asarray(red._serving_combine(red.ROM)), dtype=dtype,
            device=device) for name, red in trained.items()}
        compensated = self._compensated_active()
        V_ends = V[[0, -1]]
        x_dofs = output_dofs(fom, mode, dtype, device)
        exact = mode == "full" and fom.exact_solution is not None
        zeros = torch.zeros((N, B), dtype=dtype, device=device)
        carry = (zeros, zeros, zeros, zeros)
        steps = []
        for k in range(nt):
            uN_n, lo_n, uN_n1, _ = carry
            t = ts[k]

            def get(name, k=k, t=t):
                if name in combines:
                    values = combines[name] @ thetas[name][k]
                    return (values if name == RHS
                            else values.reshape(N, N, B))
                return sources[name][1](mu=mu, t=t)

            uh = self._state_representation(V, uN_n)
            uh_n1 = self._state_representation(V, uN_n1) if bdf2 else None
            MN, dtS = self._system_parts(get, mu, t, uh, uh_n1)
            fN = dt * get(RHS)
            if compensated:
                pred_hi, pred_lo, d, bdf = dd_predict(carry, bdf2 and k > 0)
                uN, lo = dd_correct(MN, dtS, fN, bdf, pred_hi, pred_lo, d)
            else:
                bdf = 1.5 if bdf2 and k > 0 else 1.0
                combo = 2.0 * uN_n - 0.5 * uN_n1 if bdf2 else uN_n
                uN = gauss_solve_lanes(
                    bdf * MN + dtS,
                    torch.einsum("ijB,jB->iB", MN, combo) + fN)
                lo = zeros
            out = step_outputs(fom, mu, t, uN, mode, V_ends,
                               V if mode == "full" else None, x_dofs)
            if exact:
                e = out["uc"] - fom._eval_field(fom.exact_solution, out["x"],
                                                mu, t)
                out["error"] = (torch.linalg.vector_norm(e, dim=0)
                                / float(np.sqrt(e.shape[0])))
            steps.append(out)
            carry = (uN, lo, uN_n, lo_n)
        return stack_outputs(steps, mode, carry[0])

    def solve(self, mu, step):
        """Solve the reduced problem for one μ (reference rom.py:1139-1166):
        :meth:`_online_scan` in mode "full" in the compute dtype, the μ
        recorded under ``step``; ``solutions`` is its
        :class:`~romtime_tpu_torch.base.RomSolutionsStorage` (numpy: ``ts``
        (nt,), ``fom`` and ``domain`` (nh, nt), ``rom`` (N, nt)) and, where
        the FOM has an exact solution, ``errors[idx]`` its error series.
        Returns the μ's index."""
        idx_mu, mu = self.add_mu(mu=mu, step=step)
        self._ensure_pivot_free_certified()
        outs = self._online_scan(self._mu_batch([mu]), mode="full")
        host = {k: (v if k == "t" else v[..., 0]).cpu().numpy()
                for k, v in outs.items()}
        self.solutions = RomSolutionsStorage(
            ts=host["t"], mu=mu, domain=host["x"].T, fom=host["uc"].T,
            rom=host["uN"].T)
        if "error" in host:
            self.errors[idx_mu] = host["error"]
            self.exact[idx_mu] = None
        return idx_mu

    # ------------------------------------------------------------------
    # Offline: time-windowed serving (reference rom.py:945-1041)
    # ------------------------------------------------------------------
    @offline
    def build_windowed_serving(self, n_windows, num_basis, snapshots=None,
                               overlap=2, tol_t=None):
        """Per-window bases and serving tensors (reference rom.py:949-1005):
        ``rom/windowed.py`` :func:`build_windowed_basis` on the retained
        offline snapshots (or ``snapshots``), then per window every
        reductor projected onto V_w with its folded combine V·(PᵀU)⁻¹, and
        the window's trilinear table. The global projections are restored
        after, whatever happens, and what the serving derived from them is
        made anew at its next use. Attaches and returns the
        :class:`WindowedServing`; ``build_seconds`` gets the seconds of
        the window POD (``window_pod``) and of the projections and tables
        (``window_projection``)."""
        from .windowed import WindowedServing, build_windowed_basis

        if snapshots is None:
            snapshots = self.offline_snapshots
        if not snapshots:
            raise ValueError("no offline snapshots retained — run "
                             "build_reduced_basis first or pass snapshots=")
        sources = self._theta_sources()
        for name, red in sources.items():
            if red is None:
                raise ValueError("windowed serving requires every operator "
                                 f"hyper-reduced; missing: {name}")

        t0 = time.perf_counter()
        bounds, Vs, transfers = build_windowed_basis(
            snapshots, n_windows=n_windows, num_basis=num_basis,
            overlap=overlap, tol_t=tol_t)
        t1 = time.perf_counter()
        tri_red = self.mdeim_Nh
        combines = {name: [] for name in sources}
        tri = []
        try:
            for V_w in Vs:
                for name, red in sources.items():
                    red.project_basis(V=V_w)
                    combines[name].append(red._combine_matrix(red.ROM))
                if tri_red is not None:
                    tri_red.project_basis(V=V_w)
                    T0w = self._windowed_trilinear_table(V_w)
                    if T0w is None:
                        raise ValueError(
                            "trilinear operator has no fast-path table — "
                            "windowed serving unsupported for this model")
                    tri.append(np.asarray(T0w))
        finally:
            if self.basis is not None:
                for red in sources.values():
                    red.project_basis(V=self.basis)
                if tri_red is not None:
                    tri_red.project_basis(V=self.basis)
            self._trilinear_table_cache = None
            if self._projected:
                # A built ROM's own global configuration: made anew.
                self._global_serving = None
                self._global_tables = None

        self._set_serving_windows(WindowedServing(
            bounds=bounds, Vs=Vs, transfers=transfers,
            combines={k: np.stack(v) for k, v in combines.items()},
            trilinear=np.stack(tri) if tri_red is not None else None))
        self.build_seconds.update(window_pod=t1 - t0,
                                  window_projection=time.perf_counter() - t1)
        return self.windows

    def load_windowed_serving(self, path=None):
        """Attach a configuration persisted by ``WindowedServing.dump``
        (reference rom.py:1032-1041)."""
        from .windowed import WindowedServing

        self._set_serving_windows(
            WindowedServing.load(path or StorageNames.WINDOWS))
        return self.windows

    # ------------------------------------------------------------------
    # Serving
    # ------------------------------------------------------------------
    def _set_serving_windows(self, win):
        """Swap the active windowed serving configuration. Its device
        tables are cached on the configuration object itself
        (:meth:`_cell_tables`), so a routed fleet builds and uploads each
        cell's constants once; the pivot-free certificate belongs to the
        global basis and stays."""
        self.windows = win

    def _cell_tables(self, win, key, build, device=None):
        """``build()``'s device tables for the configuration ``win``,
        cached on ``win`` under ``key`` with ``device`` (default this
        object's) and dt, as the solve policy memoizes on it; rebuilt
        when ``win``'s dilation law was replaced since. A
        :class:`~romtime_tpu_torch.rom.engines.global_fused.GlobalServing`
        caches its lanes tables the same way (it has no dilation law)."""
        cache = win.__dict__.setdefault("_serving_tables", {})
        key = (str(device or self.device), float(self.fom.dt)) + key
        dilation = getattr(win, "dilation", None)
        hit = cache.get(key)
        if hit is None or hit[0] is not dilation:
            hit = cache[key] = (dilation, build())
        return hit[1]

    def _guard_parts(self, mu, t):
        """(M_N, dt·S_N) of the global basis at (μ, t) and the zero state,
        float64 numpy: each operator is its folded combine times its raw
        gathered entries (the reference's ``assemble_*``), S_N = A_N +
        C_N + N̂_N (the trilinear term vanishes at the zero state,
        rom.py:1589-1634). Without a global configuration (an operator
        without its reductor) the reduced assembly itself,
        :meth:`_system_parts` at the zero state, as the reference's
        guard (rom.py:905-917)."""
        gs = self.global_serving
        if gs is None:
            with compute_dtype_scope(torch.float64):
                sources = self._reduction_sources()
                zero = torch.zeros(self.N, dtype=torch.float64,
                                   device=self.device)
                V = self._on_device("basis", self.basis, zero)
                MN, dtS = self._system_parts(
                    lambda name: sources[name][1](mu=mu, t=t), mu, t,
                    self._state_representation(V, zero), None)
            return (MN.cpu().numpy(), dtS.cpu().numpy())
        N = gs.N
        with compute_dtype_scope(torch.float64):
            mu_b = {k: torch.tensor([float(v)], dtype=torch.float64)
                    for k, v in mu.items()}
            t_b = torch.tensor(float(t), dtype=torch.float64)

            def op(name):
                theta = self.reductors[name]._entries_traced(mu_b, t_b)
                return (np.asarray(gs.combines[name], np.float64)
                        @ theta.numpy()[:, 0]).reshape(N, N)

            MN = op("mass")
            S = sum(op(n) for n in stiffness_side(self.SOURCES))
        return MN, float(self.fom.dt) * S

    def certify_pivot_free(self, time_probes=4, bound=None, margin=1.3):
        """Sweep cond₂(1.5·M_N + dt·S_N) of the global basis over the
        μ-box corners (the first 8) and center at ``time_probes`` times in
        [dt, tf]; return the largest. Raises ValueError above
        ``bound/margin`` (the zero-state probe misses the trilinear
        term, hence the margin). Reference ``rom.py:861-933``."""
        bound = self.PIVOT_FREE_COND_BOUND if bound is None else bound
        fom = self.fom
        dt = float(fom.dt)
        tf = float(fom.domain[fom.NT]) * dt
        if self.grid is not None:
            center = {k: 0.5 * (float(min(b)) + float(max(b)))
                      for k, b in self.grid.items()}
            probes = box_corners(self.grid)[:8] + [center]
        elif getattr(fom, "mu", None):
            probes = [dict(fom.mu)]
        else:
            self._pivot_cert = 0.0
            return 0.0
        cond_max, arg = 0.0, None
        for mu_c in probes:
            for t in np.linspace(dt, tf, time_probes):
                MN, dtS = self._guard_parts(mu_c, float(t))
                c = float(np.linalg.cond(1.5 * MN + dtS, 2))
                if c > cond_max:
                    cond_max, arg = c, (mu_c, float(t))
        self._pivot_cert = cond_max
        if cond_max > bound / margin:
            raise ValueError(
                f"pivot-free online solve refused: cond2(K_N) = "
                f"{cond_max:.3e} at mu={arg[0]}, t={arg[1]:.4g} exceeds "
                f"PIVOT_FREE_COND_BOUND/margin = {bound:.1e}/{margin} — "
                "the unpivoted elimination's growth is no longer "
                "certified O(1) for this operator family. Reduce dt, "
                "re-scale the operators, or set PIVOT_GUARD='off' to "
                "accept uncertified serving numerics.")
        return cond_max

    def _ensure_pivot_free_certified(self):
        """Run the conditioning sweep once per instance (``"auto"``);
        skipped with ``PIVOT_GUARD = "off"`` or without a global basis."""
        if self.PIVOT_GUARD == "off" or (self.global_serving is None
                                         and self.basis is None):
            return
        if self._pivot_cert is None:
            self.certify_pivot_free()

    def _windowed_tables(self):
        win = self.windows
        return self._cell_tables(win, ("windowed-pallas",), lambda: (
            windowed_tables(win, self.fom.dt,
                            stiffness_side(self._theta_sources()),
                            self.device)))

    def _lanes_tables(self, mode, device=None):
        """The lanes engine's tables of the active windows on ``device``
        (default this object's), per (mode, compute dtype)."""
        win, dtype = self.windows, compute_dtype()
        device = device or self.device
        return self._cell_tables(win, ("windowed", mode, dtype), lambda: (
            windowed_lanes_tables(win, self._theta_sources(), mode, dtype,
                                  device)), device)

    def _global_lanes_tables(self, mode):
        """The global lanes engine's tables, cached on the global
        configuration per (mode, compute dtype)."""
        gs, dtype = self.global_serving, compute_dtype()
        return self._cell_tables(gs, ("lanes", mode, dtype), lambda: (
            global_lanes_tables(gs, self._theta_sources(), mode, dtype,
                                self.device, self.STATE_DEPENDENT)))

    def _global_serving_tables(self):
        if self._global_tables is None:
            self._global_tables = global_tables(
                self.global_serving, int(self.fom.domain[self.fom.NT]),
                self.fom.dt, stiffness_side(self._theta_sources()),
                self.device)
        return self._global_tables

    def _mu_batch(self, mus):
        """(B,) tensors per μ name, in the active compute dtype (float32
        serving; float64 under ``compute_dtype_scope`` for checks)."""
        names = sorted(mus[0].keys())
        return {k: asarray([float(mu[k]) for mu in mus], device=self.device)
                for k in names}

    def prep(self, mus, engine="windowed-pallas"):
        """Stage 1 of ``engine`` for a list of μ dicts: the θ/probe tables
        on the device."""
        return self._prep_batch(self._mu_batch(mus), engine)

    def _prep_batch(self, mu, engine="windowed-pallas"):
        """:meth:`prep` on a μ batch (name → (B,) tensor, as
        :meth:`_mu_batch` makes it)."""
        if engine == "pallas":
            return global_prep(self.fom, self._theta_sources(),
                               self.global_serving,
                               self._global_serving_tables(), mu)
        return windowed_prep(self.fom, self._theta_sources(), self.windows,
                             self._windowed_tables(), mu)

    def _resolve_engine(self, mode, B):
        """The reference's engine choice (``rom.py:1262-1267``): windows
        attached and ``mode="probes"`` → ``"windowed-pallas"``; the global
        engine's gate holds → ``"pallas"``; otherwise the global lanes
        engine, ``"lanes"``, where every operator is hyper-reduced
        (:meth:`_lanes_supported`) or there is no global basis (it then
        raises), else ``"vmap"`` (:meth:`_online_scan` over the batch, its
        operators projected where no reductor is attached). The windowed lanes engine, ``"windowed"``, is taken
        only when asked for, as in the reference."""
        if self.windows is not None and mode == "probes":
            return "windowed-pallas"
        gs = self.global_serving
        if (mode == "probes" and gs is not None
                and supported(B, gs.N, compute_dtype(), self.STATE_DEPENDENT,
                              gs.trilinear is not None)):
            return "pallas"
        if self._lanes_supported() or self.basis is None:
            return "lanes"
        return "vmap"

    def _serve(self, mus, engine, mode="probes"):
        """Stages 1 and 2 of ``engine`` on the device: (nt, …, B) tensors
        (the pivot-free guard runs once per instance first)."""
        return self._serve_batch(self._mu_batch(mus), engine, mode)

    def _serve_batch(self, mu, engine, mode="probes"):
        """:meth:`_serve` on a μ batch (name → (B,) tensor, as
        :meth:`_mu_batch` makes it): the callable a benchmark chains (the
        reference's ``_get_online_fn``)."""
        if engine == "windowed":
            if self.windows is None:
                raise ValueError("no windowed serving configuration "
                                 "attached")
            self._ensure_pivot_free_certified()
            return online_sweep_windowed(
                self.fom, self.windows, self._theta_sources(),
                self._lanes_tables(mode), mu, mode)
        if engine == "lanes":
            gs = self.global_serving
            if gs is None:
                raise ValueError("no global serving configuration attached")
            self._ensure_pivot_free_certified()
            return online_scan_batch(
                self.fom, gs, self._theta_sources(),
                self._global_lanes_tables(mode), mu, mode,
                self.precompute_choice, self._compensated_active())
        if engine == "vmap":
            if self.basis is None:
                raise ValueError("the vmap engine needs the global basis")
            self._ensure_pivot_free_certified()
            return self._online_scan(mu, mode)
        if mode != "probes":
            raise NotImplementedError(
                f"engine {engine!r} serves mode='probes'; mode {mode!r} is "
                f"served by engine='lanes', 'vmap' or 'windowed'")
        if engine == "windowed-pallas":
            if self.windows is None:
                raise ValueError("no windowed serving configuration "
                                 "attached")
            self._ensure_pivot_free_certified()
            tables = self._windowed_tables()
            prepped = self._prep_batch(mu)
            return windowed_sweep(self.fom, self.windows, prepped, tables,
                                  self)
        if engine == "pallas":
            gs = self.global_serving
            if gs is None:
                raise ValueError("no global serving configuration attached")
            self._ensure_pivot_free_certified()
            tables = self._global_serving_tables()
            prepped = self._prep_batch(mu, "pallas")
            return global_sweep(self.fom, gs, prepped, tables,
                                self.precompute_choice)
        raise ValueError(
            f"unknown engine {engine!r} (the engines: 'windowed-pallas', "
            f"'pallas', 'lanes', 'vmap', 'windowed')")

    def solve_batch(self, mus, step=Stage.ONLINE, mode="reduced", engine=None,
                    host=True, probe_reduce=None):
        """Serve a μ batch on ``engine`` (default: :meth:`_resolve_engine`),
        with the reference's signature (``rom.py:1168-1169``): θ prep,
        then the stage-2 sweep the reference would take. Windowed
        (``engines/windowed_fused.windowed_sweep``): K2 per window while
        the operator tables fit the precompute budget, else the fused K1
        (its solve from :class:`SolvePolicy`) or, under
        ``ROMTIME_WINDOWED_KERNEL=v2``, K3 per window. Global
        (``engines/global_fused.global_sweep``): K4 over the materialized
        tables on the same test, else K5. Those serve ``mode="probes"``.
        ``engine="lanes"`` (``engines/global_lanes``), the reference's
        global lanes engine, ``engine="vmap"`` (:meth:`_online_scan` over
        the batch: each row that of ``solve`` on its μ) and
        ``engine="windowed"`` (``engines/windowed_lanes``), its windowed
        certification engine, serve ``"probes"``, ``"reduced"`` and
        ``"full"`` in the compute dtype (float64 under
        ``compute_dtype_scope``, else float32 with the dd carry). Without
        an engine, ``"reduced"`` and ``"full"``, and ``"probes"`` outside
        the global kernels' gate, resolve to ``"lanes"``, or to ``"vmap"``
        where an operator has no reductor (:meth:`_resolve_engine`);
        ``"lanes"`` raises ``ValueError`` where no global configuration is
        attached.

        Returns batch-first numpy arrays: ``t``, ``probes`` (B, nt, 2) —
        or (B, 2) / (B, nt//k, 2) with ``probe_reduce`` "mean" / k —
        ``uN_final`` (B, N) (probes), ``uN`` (B, nt, N) (reduced, full),
        ``uc`` and ``x`` (B, nt, nh) (full), and ``dil``/``dil_oor`` with
        a dilation law. ``host=False`` returns the (nt, …, B) device
        tensors unmoved instead, the device synchronized. Each μ is
        recorded under the stage ``step`` (``add_mu``, reference
        rom.py:1206-1207), a repeated μ in a slot of its own."""
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; the modes are "
                             f"{', '.join(MODES)}")
        for mu in mus:
            self.add_mu(mu=mu, step=step)
        if engine is None:
            engine = self._resolve_engine(mode, len(mus))
        outs = self._serve(mus, engine, mode)
        if probe_reduce is not None and "probes" in outs:
            outs["probes"] = self._reduce_probes(outs["probes"],
                                                 probe_reduce)
        if not host:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return outs
        return {k: (v.movedim(-1, 0) if v.ndim >= 2 else v).cpu().numpy()
                for k, v in outs.items()}

    @staticmethod
    def _reduce_probes(probes, probe_reduce):
        """On-device probe consumer: "mean" time-averages (nt, P, B) to
        (P, B); an int k keeps every k-th step."""
        if probe_reduce == "mean":
            return probes.mean(dim=0)
        if (isinstance(probe_reduce, (int, np.integer))
                and not isinstance(probe_reduce, bool) and probe_reduce >= 1):
            k = int(probe_reduce)
            return probes[k - 1::k]
        raise ValueError(f"probe_reduce must be 'mean' or a positive int "
                         f"stride, got {probe_reduce!r}")


class RomConstructorMoving(RomConstructor):
    """The moving-domain heat ROM: adds the reduced ALE convection
    (reference ``rom.py:1269-1288``)."""

    SOURCES = RomConstructor.SOURCES + ("convection",)
    FALLBACKS = dict(RomConstructor.FALLBACKS,
                     convection="assemble_convection")

    def assemble_convection(self, mu, t):
        return self._reduced_matrix(self.mdeim_Ch,
                                    self.fom.assemble_convection, mu, t)

    def _system_parts(self, get, mu, t, uh, uh_n1):
        """(M_N, dt·(A_N + C_N)) (reference rom.py:1282-1288)."""
        MN = get("mass")
        AN = get("stiffness")
        CN = get("convection")
        return MN, self.fom.dt * (AN + CN)


class RomConstructorNonlinear(MuLocalRoutingMixin, RomConstructorMoving):
    """The piston ROM (reference ``rom.py:1291-1634``): the Mach-stratified
    sampler, the nonlinear lifting and the trilinear term N_N(u*), served
    from the trilinear state table, BDF-2; the right-hand side is the
    lifting alone. ``mulocal`` is the attached μ-local fleet
    (:class:`~romtime_tpu_torch.rom.windowed.MuLocalWindowed`) or None;
    its cells share the reductors and swap in as the active windows."""

    SOURCES = tuple(THETA_SOURCES)
    FALLBACKS = FALLBACKS
    STATE_DEPENDENT = True

    # Forcing bounds of the stratified sampler (reference rom.py:1296-1298)
    PISTON_MACH_MIN = 0.15
    PISTON_MACH_MAX = 0.4

    def _serving_attrs(self):
        """Every θ source's reductor and the trilinear N-MDEIM."""
        return super()._serving_attrs() + [
            REDUCTOR_ATTRS[OperatorType.TRILINEAR]]

    # ------------------------------------------------------------------
    # Mach-stratified sampling (reference rom.py:1308-1348)
    # ------------------------------------------------------------------
    def build_sampling_space(self, num, rnd=None):
        """``num`` μ, one per equal-width Mach bin over
        [PISTON_MACH_MIN, PISTON_MACH_MAX], the first hit of each bin in
        a stream of 2·10⁴ draws from ``sampling_grid``, sorted by Mach
        (each tagged with its ``piston_mach``)."""
        edges = self.compute_piston_mach_number_space(
            grid=self.sampling_grid, num=num, mach_min=self.PISTON_MACH_MIN,
            mach_max=self.PISTON_MACH_MAX)
        sampler = ParameterSampler(self.sampling_grid, n_iter=int(2e4),
                                   random_state=rnd)
        samples = []
        domains = list(zip(edges, edges[1:]))
        for sample in sampler:
            piston_mach = self.compute_piston_mach_number(sample)
            remove = None
            for start, end in domains:
                if start <= piston_mach <= end:
                    sample[PistonParameters.MACH_PISTON] = piston_mach
                    samples.append(sample)
                    remove = (start, end)
                    break
            if remove is not None:
                domains.remove(remove)
            if len(domains) == 0:
                break
        return sorted(samples, key=lambda x: x[PistonParameters.MACH_PISTON])

    # ------------------------------------------------------------------
    # The trilinear state table: N_N(u*) = b0(μ)·T0 @ u*_N
    #
    # The (1,0) trilinear form is scale-invariant under the ALE pull-back
    # and its DEIM entries are linear in the state, the μ-dependence the
    # scalar b0 = (γ+1)/2·a0; so the reduced operator is one constant
    # (N², N) contraction per step. Detected numerically; None where the
    # invariance does not hold (reference rom.py:1475-1587).
    # ------------------------------------------------------------------
    def _trilinear_state_table(self, V_np):
        """The table of the basis ``V_np``, cached per N-MDEIM object; on
        a serving object without the N-MDEIM, its global configuration's
        (None without one)."""
        if self.mdeim_Nh is None:
            gs = self._global_serving
            return None if gs is None else gs.trilinear
        cached = self._trilinear_table_cache
        if cached is not None and cached[0] is self.mdeim_Nh:
            return cached[1]
        table = self._build_trilinear_state_table(V_np)
        self._trilinear_table_cache = (self.mdeim_Nh, table)
        return table

    def _build_trilinear_state_table(self, V_np):
        """Float64 whatever the serving dtype (the probe runs at 1e-9),
        on the FOM's device."""
        red = self.mdeim_Nh
        if red is None or red.PT_U_inv is None or red.basis_rom is None:
            return None
        with compute_dtype_scope(torch.float64):
            return self._build_trilinear_state_table_impl(
                np.asarray(V_np, np.float64), red)

    def _build_trilinear_state_table_impl(self, V_np, red):
        fom = self.fom
        N = V_np.shape[1]

        def entries_over_basis(mu, t):
            # All N unit-coefficient states in one lane-batched assembly.
            vals = fom.assemble_trilinear(
                mu=red._mu_tensors(mu), t=red._times(t),
                u_n=(V_np, red._times(np.eye(N))), entries=red.dofs)
            return vals.cpu().numpy()  # (n_ent, N)

        mu_a = (dict(self.mu_space[Stage.OFFLINE][0])
                if self.mu_space[Stage.OFFLINE] else dict(fom.mu))
        mu_b = {k: v * 1.17 + 0.013 for k, v in mu_a.items()}
        b0_a = float(fom.nonlinear_coefficient(mu_a))
        b0_b = float(fom.nonlinear_coefficient(mu_b))
        T = float(fom.domain[fom.T])
        E_a = entries_over_basis(mu_a, 0.37 * T) / b0_a
        E_b = entries_over_basis(mu_b, 0.81 * T) / b0_b
        scale = max(np.abs(E_a).max(), 1e-30)
        if not np.allclose(E_a, E_b, atol=1e-9 * scale, rtol=1e-9):
            return None  # not scale-invariant
        if os.environ.get("ROMTIME_TRI_TABLE") == "deim":
            # The N-MDEIM reconstruction (the reference's opt-in
            # ablation): basis_rom (N², k) · PᵀU⁻¹ (k, n_ent) · E0.
            return red.basis_rom @ (red.PT_U_inv @ E_a)
        return self._trilinear_exact_columns(V_np, mu_a, b0_a)

    def _trilinear_exact_columns(self, V_np, mu_a, b0_a):
        """vec(Vᵀ·N(V e_j)·V)/b0 of every basis column j: one full-band
        assembly on the FOM's device with the N columns as its trailing
        batch, then the two-sided projection there (reference
        rom.py:1561-1587, which projects on the host). Float64."""
        red = self.mdeim_Nh
        with compute_dtype_scope(torch.float64):
            band = self.fom.assemble_trilinear(
                mu=red._mu_tensors(mu_a),
                t=red._times(0.37 * float(self.fom.domain[self.fom.T])),
                u_n=red._times(V_np)).band                # (2p+1, nh, N)
        return project_band(band, V_np) / b0_a

    # ------------------------------------------------------------------
    # The piston's reduced operators (reference rom.py:1384-1419)
    # ------------------------------------------------------------------
    def assemble_trilinear(self, mu, t, uh):
        """N_N(u*) (reference rom.py:1384-1387)."""
        return self._reduced_matrix(self.mdeim_Nh,
                                    self.fom.assemble_trilinear, mu, t,
                                    u_n=uh)

    def assemble_nonlinear_lifting(self, mu, t):
        """N̂_N (reference rom.py:1389-1393)."""
        return self._reduced_matrix(self.mdeim_Nh_hat,
                                    self.fom.assemble_nonlinear_lifting,
                                    mu, t)

    def assemble_lifting(self, mu, t):
        """The piston's right-hand side, the lifting vector (reference
        rom.py:1415-1419)."""
        return self._reduced_vector(self.deim_rhs, self.fom.assemble_lifting,
                                    mu, t)

    def assemble_system_rhs(self, mu, t, MN_mat, uN_n, uN_n1=None):
        """b_N = M_N·(2u_N − ½u_N₋₁) + dt·f_gN, or M_N·u_N + dt·f_gN
        without a history (reference rom.py:1405-1413)."""
        fgN = self.assemble_lifting(mu=mu, t=t)
        if uN_n1 is None:
            bdf_term = MN_mat @ uN_n
        else:
            bdf_term = MN_mat @ (2.0 * uN_n - 0.5 * uN_n1)
        return bdf_term + self.fom.dt * fgN

    def _has_state_table(self):
        """The trilinear state table is at hand: the N-MDEIM's, or a
        serving object's global configuration's."""
        gs = self._global_serving
        return self.mdeim_Nh is not None or (
            gs is not None and gs.trilinear is not None)

    def _state_representation(self, V, uN):
        """The state handed to the trilinear operator: the factorized
        (basis, u_N) where the state table is at hand (the loop stays
        Nh-free), else the FOM vector V·u_N for the projection fallback."""
        if self._has_state_table():
            return (np.asarray(self.basis), uN)
        return V @ uN

    def _system_parts(self, get, mu, t, uh, uh_n1):
        """(M_N, dt·(A_N + C_N + N_N(u*) + N̂_N)) from the per-step operator
        getter, u* = 2u_n − u_{n−1} (u_n without a history). The trilinear
        term comes from the exact state table b0·(T0 @ u*_N) wherever the
        state is factorized, as in the lanes engines (their S-ROM
        estimates would part otherwise); else from ``assemble_trilinear``."""
        MN = get("mass")
        AN = get("stiffness")
        CN = get("convection")
        NhatN = get("nonlinear_lifting")
        if uh_n1 is None:
            u_star = uh
        elif isinstance(uh, tuple):
            u_star = (uh[0], 2.0 * uh[1] - uh_n1[1])
        else:
            u_star = 2.0 * uh - uh_n1
        NN = None
        if isinstance(u_star, tuple):
            cN = u_star[1]
            T0 = self._trilinear_state_table(u_star[0])
            if T0 is not None:
                T0 = self._on_device("trilinear", T0, cN)
                NN = (T0 @ cN).reshape((self.N, self.N) + tuple(
                    cN.shape[1:])) * self.fom.nonlinear_coefficient(mu)
        if NN is None:
            NN = self.assemble_trilinear(mu=mu, t=t, uh=u_star)
        return MN, self.fom.dt * (AN + CN + NN + NhatN)

    def _lanes_supported(self):
        """The lanes engines need every operator hyper-reduced and the
        trilinear term's state table (reference rom.py:1051-1060, whose
        table comes from the N-MDEIM)."""
        return (all(red is not None for red in self.reductors.values())
                and self._has_state_table())

    def _windowed_trilinear_table(self, V_w):
        """The trilinear state table of a window's basis (the N-MDEIM
        already projected onto ``V_w``); exact unless
        ``ROMTIME_TRI_TABLE=deim`` (reference rom.py:1444-1453)."""
        return self._build_trilinear_state_table(np.asarray(V_w))


    @staticmethod
    def compute_piston_mach_number(sample):
        """δω/a0."""
        return (sample[PistonParameters.DELTA]
                * sample[PistonParameters.OMEGA]
                / sample[PistonParameters.A0])

    @staticmethod
    def compute_piston_mach_number_space(grid, num, mach_min=None,
                                         mach_max=None):
        """``num`` + 1 equal-width bin edges across the admissible Mach
        range of the μ box of ``grid`` (name → (lo, hi), or the
        distributions whose supports span it), reference
        ``rom.py:1359-1379``: δ_min·ω_min/a0_max to δ_max·ω_max/a0_min
        unless ``mach_min``/``mach_max`` say otherwise."""
        A0, OMEGA, DELTA = (PistonParameters.A0, PistonParameters.OMEGA,
                            PistonParameters.DELTA)
        box = grid_box({k: grid[k] for k in (A0, OMEGA, DELTA)})
        lo = {k: box[k][0] for k in box}
        hi = {k: box[k][1] for k in box}
        if mach_min is None:
            mach_min = lo[DELTA] * lo[OMEGA] / hi[A0]
        if mach_max is None:
            mach_max = hi[DELTA] * hi[OMEGA] / lo[A0]
        return np.linspace(start=mach_min, stop=mach_max, num=num + 1)
