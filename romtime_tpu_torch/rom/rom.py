"""Piston ROM serving (counterpart of the serving path of
``romtime_tpu/rom/rom.py``: ``RomConstructorNonlinear.solve_batch`` with
``mode="probes"`` on windowed serving, the ``"windowed-pallas"`` engine,
and on the global basis, the ``"pallas"`` engine, behind the reference's
pivot-free guard ``certify_pivot_free``; the global lanes engine
``"lanes"`` and the windowed lanes engine ``"windowed"`` in every mode,
float64 or float32; a μ-local fleet routed by Mach cell,
``solve_batch_mulocal``).

The offline build (POD, DEIM training, window construction, the
trilinear state table) stays in the JAX package; a serving object here is
made from its artifacts (``convert.serving_from_arrays``,
``convert.global_serving_from_arrays``,
``convert.fleet_serving_from_arrays``) or from seeded synthetic data
(``testing.synthetic``).
"""

import numpy as np
import torch

from ..conventions import PistonParameters, Stage
from ..dtypes import asarray, compute_dtype, compute_dtype_scope
from ..deim import (
    DiscreteEmpiricalInterpolation,
    MatrixDiscreteEmpiricalInterpolation,
)
from .engines.autotune import AutotuneMixin
from .engines.mulocal import MuLocalRoutingMixin
from .engines.global_fused import (
    global_prep,
    global_sweep,
    global_tables,
    supported,
)
from .engines.global_lanes import global_lanes_tables, online_scan_batch
from .engines.policy import PrecomputePolicy, SolvePolicy, box_corners
from .engines.windowed_fused import (
    windowed_prep,
    windowed_sweep,
    windowed_tables,
    stiffness_side,
)
from .engines.windowed_lanes import (
    MODES,
    online_sweep_windowed,
    windowed_lanes_tables,
)

#: θ source name → (reductor class, FOM assembly method), in the
#: reference's ``_theta_sources`` order (rom.py:525, :1277, :1421), which
#: fixes the stiffness-side row order of the θ tables.
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


def make_reductors(fom, dofs, reduced=None):
    """Serving reductors bound to ``fom`` from per-source dofs;
    ``reduced`` maps a source name to its optional ``PT_U`` and
    ``basis_rom`` (the global basis's float64 θ-solve)."""
    reduced = reduced or {}
    return {
        name: cls(assemble=getattr(fom, method), dofs=dofs[name], name=name,
                  **reduced.get(name, {}))
        for name, (cls, method) in THETA_SOURCES.items()
    }


class RomConstructorNonlinear(MuLocalRoutingMixin, AutotuneMixin,
                              PrecomputePolicy, SolvePolicy):
    """Piston serving on one device (the card unless ``device`` says
    otherwise).

    ``reductors`` maps every θ source name of :data:`THETA_SOURCES` to a
    DEIM reductor bound to ``fom``; ``windows`` is the active
    :class:`~romtime_tpu_torch.rom.windowed.WindowedServing` and
    ``global_serving`` the global-basis
    :class:`~romtime_tpu_torch.rom.engines.global_fused.GlobalServing`:
    one of them, or both (windows then serve by default, as in the
    reference, and the global basis carries the pivot-free guard).
    ``grid`` is the μ box, name → (lo, hi), that the guard and the auto
    solve policy probe. ``mulocal`` is the attached μ-local fleet
    (:class:`~romtime_tpu_torch.rom.windowed.MuLocalWindowed`) or None;
    its cells share the reductors and swap in as the active windows."""

    # The online engines eliminate without pivoting, justified by the
    # M-dominance of K_N = bdf·M_N + dt·S_N; the certifiable proxy is
    # cond₂(K_N) ≤ PIVOT_FREE_COND_BOUND over the μ box (reference
    # rom.py:842-859). "auto": certify once per instance; "off": skip.
    PIVOT_FREE_COND_BOUND = 1e4
    PIVOT_GUARD = "auto"

    def __init__(self, fom, reductors, windows=None, device="cuda",
                 global_serving=None, grid=None):
        missing = set(THETA_SOURCES) - set(reductors)
        if missing:
            raise ValueError(f"missing θ sources: {sorted(missing)}")
        if windows is None and global_serving is None:
            raise ValueError("a serving object needs windows or a global "
                             "serving configuration")
        self.fom = fom
        self.reductors = dict(reductors)
        self.device = torch.device(device)
        self.global_serving = global_serving
        self.grid = None if grid is None else {
            k: (float(lo), float(hi)) for k, (lo, hi) in grid.items()}
        self._global_tables = None
        self._pivot_cert = None
        self.mulocal = None
        self._set_serving_windows(windows)

    @property
    def N(self):
        """The windows' N with windows attached, else the global N."""
        if self.windows is not None:
            return self.windows.N
        return self.global_serving.N

    def _theta_sources(self):
        """name → reductor, in the reference's source order."""
        return {name: self.reductors[name] for name in THETA_SOURCES}

    def _set_serving_windows(self, win):
        """Swap the active windowed serving configuration. Its device
        tables are cached on the configuration object itself
        (:meth:`_cell_tables`), so a routed fleet builds and uploads each
        cell's constants once; the pivot-free certificate belongs to the
        global basis and stays."""
        self.windows = win

    def _cell_tables(self, win, key, build):
        """``build()``'s device tables for the configuration ``win``,
        cached on ``win`` under ``key`` with this object's device and dt,
        as the solve policy memoizes on it; rebuilt when ``win``'s
        dilation law was replaced since. A
        :class:`~romtime_tpu_torch.rom.engines.global_fused.GlobalServing`
        caches its lanes tables the same way (it has no dilation law)."""
        cache = win.__dict__.setdefault("_serving_tables", {})
        key = (str(self.device), float(self.fom.dt)) + key
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
        rom.py:1589-1634)."""
        gs = self.global_serving
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
            S = sum(op(n) for n in stiffness_side(THETA_SOURCES))
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
        if self.PIVOT_GUARD == "off" or self.global_serving is None:
            return
        if self._pivot_cert is None:
            self.certify_pivot_free()

    def _windowed_tables(self):
        win = self.windows
        return self._cell_tables(win, ("windowed-pallas",), lambda: (
            windowed_tables(win, self.fom.dt,
                            stiffness_side(self._theta_sources()),
                            self.device)))

    def _lanes_tables(self, mode):
        """The lanes engine's tables of the active windows, per (mode,
        compute dtype)."""
        win, dtype = self.windows, compute_dtype()
        return self._cell_tables(win, ("windowed", mode, dtype), lambda: (
            windowed_lanes_tables(win, self._theta_sources(), mode, dtype,
                                  self.device)))

    def _global_lanes_tables(self, mode):
        """The global lanes engine's tables, cached on the global
        configuration per (mode, compute dtype)."""
        gs, dtype = self.global_serving, compute_dtype()
        return self._cell_tables(gs, ("lanes", mode, dtype), lambda: (
            global_lanes_tables(gs, self._theta_sources(), mode, dtype,
                                self.device)))

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
        mu = self._mu_batch(mus)
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
        engine, ``"lanes"``. The reference's vmap engine, taken only where
        an operator has no trained reductor (``rom.py:1051-1061``), is not
        ported (ROADMAP Queue 1, item 4): a serving object holds every
        reductor, so it never resolves there. The windowed lanes engine,
        ``"windowed"``, is taken only when asked for, as in the
        reference."""
        if self.windows is not None and mode == "probes":
            return "windowed-pallas"
        gs = self.global_serving
        if (mode == "probes" and gs is not None
                and supported(B, gs.N, compute_dtype(),
                              gs.trilinear is not None)):
            return "pallas"
        return "lanes"

    def _serve(self, mus, engine, mode="probes"):
        """Stages 1 and 2 of ``engine`` on the device: (nt, …, B) tensors
        (the pivot-free guard runs once per instance first)."""
        if engine == "windowed":
            if self.windows is None:
                raise ValueError("no windowed serving configuration "
                                 "attached")
            self._ensure_pivot_free_certified()
            return online_sweep_windowed(
                self.fom, self.windows, self._theta_sources(),
                self._lanes_tables(mode), self._mu_batch(mus), mode)
        if engine == "lanes":
            gs = self.global_serving
            if gs is None:
                raise ValueError("no global serving configuration attached")
            self._ensure_pivot_free_certified()
            return online_scan_batch(
                self.fom, gs, self._theta_sources(),
                self._global_lanes_tables(mode), self._mu_batch(mus), mode,
                self.precompute_choice)
        if mode != "probes":
            raise NotImplementedError(
                f"engine {engine!r} serves mode='probes'; mode {mode!r} is "
                f"served by engine='lanes' or 'windowed'")
        if engine == "windowed-pallas":
            if self.windows is None:
                raise ValueError("no windowed serving configuration "
                                 "attached")
            self._ensure_pivot_free_certified()
            tables = self._windowed_tables()
            prepped = self.prep(mus)
            return windowed_sweep(self.fom, self.windows, prepped, tables,
                                  self)
        if engine == "pallas":
            gs = self.global_serving
            if gs is None:
                raise ValueError("no global serving configuration attached")
            self._ensure_pivot_free_certified()
            tables = self._global_serving_tables()
            prepped = self.prep(mus, engine="pallas")
            return global_sweep(self.fom, gs, prepped, tables,
                                self.precompute_choice)
        raise NotImplementedError(
            f"engine {engine!r} is not ported (ported: 'windowed-pallas', "
            f"'pallas', 'lanes', 'windowed'; the reference's 'vmap' engine "
            f"is ROADMAP Queue 1, item 4)")

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
        global lanes engine, and ``engine="windowed"``
        (``engines/windowed_lanes``), its windowed certification engine,
        serve ``"probes"``, ``"reduced"`` and ``"full"`` in the compute
        dtype (float64 under ``compute_dtype_scope``, else float32 with
        the dd carry). Without an engine, ``"reduced"`` and ``"full"``,
        and ``"probes"`` outside the global kernels' gate, resolve to
        ``"lanes"`` (:meth:`_resolve_engine`); it raises ``ValueError``
        where no global configuration is attached.

        Returns batch-first numpy arrays: ``t``, ``probes`` (B, nt, 2) —
        or (B, 2) / (B, nt//k, 2) with ``probe_reduce`` "mean" / k —
        ``uN_final`` (B, N) (probes), ``uN`` (B, nt, N) (reduced, full),
        ``uc`` and ``x`` (B, nt, nh) (full), and ``dil``/``dil_oor`` with
        a dilation law. ``host=False`` returns the (nt, …, B) device
        tensors unmoved instead, the device synchronized. ``step`` is the
        reference's stage tag; serving keeps no record of the μ it
        served."""
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; the modes are "
                             f"{', '.join(MODES)}")
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
        range of the μ box ``grid`` (name → (lo, hi)), reference
        ``rom.py:1359-1379``: δ_min·ω_min/a0_max to δ_max·ω_max/a0_min
        unless ``mach_min``/``mach_max`` say otherwise."""
        A0, OMEGA, DELTA = (PistonParameters.A0, PistonParameters.OMEGA,
                            PistonParameters.DELTA)
        lo = {k: float(min(grid[k])) for k in (A0, OMEGA, DELTA)}
        hi = {k: float(max(grid[k])) for k in (A0, OMEGA, DELTA)}
        if mach_min is None:
            mach_min = lo[DELTA] * lo[OMEGA] / hi[A0]
        if mach_max is None:
            mach_max = hi[DELTA] * hi[OMEGA] / lo[A0]
        return np.linspace(start=mach_min, stop=mach_max, num=num + 1)
