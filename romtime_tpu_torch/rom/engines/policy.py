"""Serving policy (counterpart of ``romtime_tpu/rom/engines/policy.py``
and of the precompute constants of ``romtime_tpu/rom/rom.py:96-98``).

Stage 2 of windowed serving takes one of three branches, as the
reference's does (``windowed_pallas.py:310-488``): materialized operator
tables and one K2 launch per window while the tables fit the precompute
budget (:class:`PrecomputePolicy`), otherwise the θ-streaming sweep that
``ROMTIME_WINDOWED_KERNEL`` names (:func:`windowed_kernel`): the fused K1
by default, or a K3 launch per window. The global engine takes K4 over
materialized tables or K5 on the same test.

The fused sweep's solve (:class:`SolvePolicy`) is the reference's: the
per-window Richardson solve when the measured within-window contraction
reaches the f32 band in few enough iterations (``WINDOWED_SOLVE_ITERS =
"auto"``), else the pivot-free LU. The port factorizes at every step
(``WINDOWED_PAIRED_LU = None``), where the reference reuses one
factorization per group of 5 steps by default: on the flagship's top
Mach cell, built by the port, the stale factors' follower solves diverge
in the fast wave phases (‖I − K_lead⁻¹K‖ up to 1.5), and that schedule
leaves the per-step LU by ~0.17 of the probes where the per-step LU meets
the served-vs-lanes limit. ``ROMTIME_PAIRED_LU=5`` (any group ≥ 2) opts
into the reference's schedule; ``ROMTIME_PAIRED_MODE`` picks how its
followers reuse the leader's factors, one of the reference's six modes
(``"sub1"`` by default: substitute with them and refine once against
their own matrix; ``ops/windowed_fused.py`` describes the others). An
unknown mode raises ``ValueError``, where the reference would serve
``"sub1"`` without a word.
"""

import itertools
import os

import numpy as np
import torch

from ...dtypes import compute_dtype_scope
from ...ops.windowed_fused import PAIRED_MODES

WINDOWED_PAIRED_LU = None
WINDOWED_PAIRED_MODE = "sub1"

_UNSET = object()


class PrecomputePolicy:
    """Matrices-vs-θ choice of the serving engines (reference
    ``SolvePolicyMixin._precompute_choice``): the measured override that
    ``autotune_online_precompute`` or ``load_autotune`` pins wins, bounded
    by the hard cap; otherwise the static byte budget. The budget and the
    cap stay the reference's 6 and 12 GiB so that the port routes as the
    reference routes, although the card holds 80 GB."""

    ONLINE_PRECOMPUTE = "matrices"
    ONLINE_PRECOMPUTE_BUDGET = 6 * 1024**3       # bytes
    ONLINE_PRECOMPUTE_HARD_CAP = 12 * 1024**3    # bytes
    _precompute_override = None                  # "matrices" | "thetas"

    def precompute_choice(self, mat_bytes):
        """True → materialize the operator time tables (``mat_bytes`` of
        them) and sweep over them (K2 per window, or K4)."""
        override = self._precompute_override
        if override is not None:
            return (override == "matrices"
                    and mat_bytes <= self.ONLINE_PRECOMPUTE_HARD_CAP)
        return (self.ONLINE_PRECOMPUTE == "matrices"
                and mat_bytes <= self.ONLINE_PRECOMPUTE_BUDGET)


def windowed_kernel():
    """θ-streaming kernel generation, read from ``ROMTIME_WINDOWED_KERNEL``
    as the reference reads it: ``"fused"`` (the default, K1) or, for any
    other value, ``"v2"`` (K3 launches per window)."""
    if os.environ.get("ROMTIME_WINDOWED_KERNEL", "fused") == "fused":
        return "fused"
    return "v2"


def windowed_paired_lu():
    """Group size (≥ 2) or None; ``ROMTIME_PAIRED_LU`` overrides."""
    env = os.environ.get("ROMTIME_PAIRED_LU")
    if env is not None and env != "":
        n = int(env)
        return n if n >= 2 else None
    return WINDOWED_PAIRED_LU


def windowed_paired_mode():
    """Follower mode; ``ROMTIME_PAIRED_MODE`` overrides. Raises
    ``ValueError`` for a mode that is not one of the six."""
    mode = os.environ.get("ROMTIME_PAIRED_MODE", WINDOWED_PAIRED_MODE)
    if mode not in PAIRED_MODES:
        raise ValueError(f"unknown paired-LU follower mode {mode!r} "
                         f"(ROMTIME_PAIRED_MODE); the modes are "
                         f"{', '.join(PAIRED_MODES)}")
    return mode


def paired_lu_period(width, K8, n_real):
    """Steps per paired-LU schedule period: the reference's kernel chunk
    ``_fused_chunk`` (``pallas_online.py:1591-1602``), the largest divisor
    of the window width within min(75, its 44 MiB θ-slot budget,
    60 above N=20 else ⌊1152/N⌋). Each period opens with two full LUs, so
    the rule fixes which steps refactorize, and the port keeps it."""
    slot_cap = max(1, (44 * 1024 * 1024) // (2 * K8 * 128 * 4))
    compile_cap = 60 if n_real > 20 else max(1, 1152 // max(n_real, 1))
    cap = min(75, slot_cap, compile_cap)
    for c in range(min(cap, width), 0, -1):
        if width % c == 0:
            return c
    return 1


def box_corners(grid):
    """The distinct corners of the μ box ``grid`` (name → (lo, hi)), in
    the reference's ``itertools.product`` order."""
    corners = []
    for vals in itertools.product(*[(float(min(b)), float(max(b)))
                                    for b in grid.values()]):
        mu = dict(zip(grid.keys(), vals))
        if mu not in corners:
            corners.append(mu)
    return corners


class SolvePolicy:
    """The fused sweep's per-step solve (reference ``SolvePolicyMixin``,
    ``policy.py:64-274``). Class attributes an instance may override:

    - ``WINDOWED_SOLVE_ITERS``: ``"auto"`` (measure ρ, below), an
      iteration count, or None (the LU); ``ROMTIME_SOLVE_ITERS`` overrides
      (0 → LU, n → n);
    - ``WINDOWED_SOLVE_ITERS_CAP`` (accuracy) and
      ``WINDOWED_SOLVE_ITERS_PERF_CAP`` (the reference's measured
      crossover against the LU): "auto" takes the LU above the smaller.

    Needs ``self.fom``, ``self.grid`` (name → (lo, hi)), ``self.windows``,
    ``self.mulocal`` and ``self._theta_sources()``."""

    WINDOWED_SOLVE_ITERS = "auto"
    WINDOWED_SOLVE_ITERS_CAP = 12
    WINDOWED_SOLVE_ITERS_PERF_CAP = 5

    def windowed_solve(self):
        """(solve_iters, paired-LU group, mode) of the fused sweep: with
        Richardson iterations the group is unused (Richardson takes
        precedence, reference ``pallas_online.py:1489``); group None means
        the per-step LU."""
        return (self._windowed_solve_iters(), windowed_paired_lu(),
                windowed_paired_mode())

    def _windowed_solve_iters(self):
        env = os.environ.get("ROMTIME_SOLVE_ITERS")
        if env is not None and env != "":
            n = int(env)
            return n if n > 0 else None
        setting = self.WINDOWED_SOLVE_ITERS
        if setting == "auto":
            return self._auto_solve_iters()
        return setting

    def _auto_solve_iters(self):
        """The measured Richardson iteration count of the active windows,
        or None (→ LU). With a μ-local fleet attached whose cells include
        the active windows, the worst case over the active cell's (W, N)
        group decides (reference ``policy.py:160-185``): the LU if any
        cell of the group needs it, else the largest count, cached per
        fleet and shape (``_auto_iters_cache_ml``). Same-shape cells serve
        with one setting in the reference, where it is baked into one
        compiled kernel; the port keeps the rule."""
        win = self.windows
        if win is None:
            return None
        ml = getattr(self, "mulocal", None)
        if ml is not None and any(win is c for c in ml.cells):
            shape = (win.n_windows, win.N)
            cache = getattr(self, "_auto_iters_cache_ml", None)
            if (isinstance(cache, dict) and cache.get("ml") is ml
                    and shape in cache):
                return cache[shape]
            group = [c for c in ml.cells if (c.n_windows, c.N) == shape]
            per_cell = [self._auto_iters_for(c) for c in group]
            result = (None if any(r is None for r in per_cell)
                      else max(per_cell))
            if not isinstance(cache, dict) or cache.get("ml") is not ml:
                cache = {"ml": ml}
                self._auto_iters_cache_ml = cache
            cache[shape] = result
            return result
        return self._auto_iters_for(win)

    def _auto_iters_for(self, win):
        """ρ = max ‖I − K̄_w⁻¹K(μ, t)‖₂ over the μ-box corners and the
        window ends (:meth:`_auto_iters_rho`), then ρ_eff = min(1.3ρ + 0.02,
        0.999) and ⌈log 3e-8 / log ρ_eff⌉ iterations, or None above
        min(cap, perf cap). Memoized on the windows object, with ρ beside
        it (``win._auto_iters_rho_value``)."""
        memo = getattr(win, "_auto_iters_memo", _UNSET)
        if memo is not _UNSET:
            return memo
        if self.grid is None:
            raise ValueError("the auto solve policy needs the μ box "
                             "(grid) of the serving configuration")
        fom = self.fom
        sources = self._theta_sources()
        stiff = [n for n in sources if n not in ("mass", "rhs_vec")]
        rho = self._auto_iters_rho(
            box_corners(self.grid)[:8], np.asarray(win.bounds), sources,
            stiff, float(fom.dt), win.n_windows, win.N, win)
        rho_eff = min(rho * 1.3 + 0.02, 0.999)
        iters = int(np.ceil(np.log(3e-8) / np.log(rho_eff)))
        cap = min(self.WINDOWED_SOLVE_ITERS_CAP,
                  self.WINDOWED_SOLVE_ITERS_PERF_CAP)
        result = iters if iters <= cap else None
        win._auto_iters_memo = result
        win._auto_iters_rho_value = rho
        return result

    def _auto_iters_rho(self, corners, bounds, sources, stiff, dt, W, N,
                        win):
        """Eager float64 probe on the CPU (as the reference pins it): at
        each corner and each window of ``range(0, W, max(1, W // 4))``,
        K̄ is the mean of the linear step matrix 1.5·M + dt·S at the window's
        first and last steps, and ρ the largest ‖I − K̄⁻¹K‖₂ at those two
        steps."""
        rho = 0.0
        with compute_dtype_scope(torch.float64):
            for mu_c in corners:
                mu_b = {k: torch.tensor([v], dtype=torch.float64)
                        for k, v in mu_c.items()}

                def K_at(w, step, mu_b=mu_b):
                    t = torch.tensor((step + 1) * dt, dtype=torch.float64)
                    K = 1.5 * (sources["mass"]._entries_traced(mu_b, t)
                               .numpy()[:, 0]
                               @ np.asarray(win.combines["mass"][w]).T)
                    for nm in stiff:
                        K = K + dt * (sources[nm]._entries_traced(mu_b, t)
                                      .numpy()[:, 0]
                                      @ np.asarray(win.combines[nm][w]).T)
                    return K.reshape(N, N)

                for w in range(0, W, max(1, W // 4)):
                    a, b = int(bounds[w]), int(bounds[w + 1]) - 1
                    Kinv = np.linalg.inv(0.5 * (K_at(w, a) + K_at(w, b)))
                    for s in (a, b):
                        M = np.eye(N) - Kinv @ K_at(w, s)
                        rho = max(rho, float(np.linalg.norm(M, 2)))
        return rho
