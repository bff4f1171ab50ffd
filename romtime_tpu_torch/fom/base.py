"""Abstract 1-D full-order solver (counterpart of
``romtime_tpu/fom/base.py``).

Operators are assembled either over the full band (``entries=None``; a
:class:`BandedOperator`) or at DEIM entries only (the serving path; an
empty entry list raises rather than fall back to the band). The moving
mesh enters as the ALE pull-back factor Lt(μ, t) on quadrature
coordinates and cell widths; no mesh object moves.

μ and t are tensors in the compute dtype, as the problem callables take
them. A μ whose leaves are (B,) tensors is a batch: every coefficient,
band (2p+1, nh, B) and state (nh, B) then carries B as its trailing axis,
as the reference's lane-batched assembly does, and the banded solve sees
the batch as its leading axis through a view. The BDF time loop
(:meth:`OneDimensionalSolver._solve_impl`) and its compensated residual
form (:meth:`OneDimensionalSolver._solve_impl_dd`) are eager torch,
stepping on the solver's device (the card unless ``device="cpu"``), with
each step written into preallocated (nt, …) outputs; they return the
reference's outputs, a leading μ axis on a batch.
"""

import contextlib
from abc import ABC, abstractmethod

import numpy as np
import torch

from ..base import SolutionsStorage
from ..conventions import BDF, BoundaryConditions, Domain
from ..dtypes import compute_dtype, full_f32_matmul, require_full_f32_matmul
from ..ops.assembly import (
    _dofs_at,
    apply_dirichlet_band,
    apply_dirichlet_vector,
    apply_entry_dirichlet,
    assemble_bilinear_band,
    assemble_bilinear_entries,
    assemble_linear_entries,
    assemble_linear_vector,
    band_gather_nnz,
    band_matvec,
    band_nonzero_entries,
    band_to_dense,
    eval_function_at,
    norm_H1,
    norm_L2,
)
from ..ops.compensated import dd_add_small, dd_bdf2_predict, dd_history_diff
from ..ops.linalg import solve_banded
from ..ops.mesh import Mesh1D


def move_mesh(assemble):
    """API-parity decorator: marks an assembly method as moving-mesh (the
    pull-back scale is applied inside the assembly)."""
    assemble.__moving__ = True
    return assemble


def _sum(values):
    """Left-to-right sum of a non-empty iterable of tensors."""
    values = iter(values)
    total = next(values)
    for v in values:
        total = total + v
    return total


class BandedOperator:
    """Assembled operator in banded storage, band (2p+1, nh, ...), with a
    scipy-CSR-like face: ``.data`` is ``csr.data`` on the stored-nonzero
    pattern; ``todense``/``dot`` serve tests and projections."""

    def __init__(self, band, mesh):
        self.band = band
        self.mesh = mesh

    @property
    def p(self):
        return self.mesh.degree

    @property
    def shape(self):
        return (self.mesh.nh, self.mesh.nh)

    def todense(self):
        """(nh, nh) numpy, or (..., nh, nh) for a batched band."""
        band = torch.movedim(self.band, (0, 1), (-2, -1))
        return band_to_dense(band, self.p).cpu().numpy()

    def array(self):
        return self.todense()

    def dot(self, v):
        return band_matvec(self.band, v, self.p)

    def __mul__(self, v):
        return self.dot(v)

    def nonzero_entries(self, tolerance=None):
        return band_nonzero_entries(self.band, self.mesh, tolerance=tolerance)

    @property
    def data(self):
        rows, cols, values = self.nonzero_entries()
        return values

    def gather(self, rows, cols):
        return band_gather_nnz(self.band, rows, cols, self.p)

    def __add__(self, other):
        band = other.band if isinstance(other, BandedOperator) else other
        return BandedOperator(self.band + band, self.mesh)

    def __rmul__(self, scalar):
        return BandedOperator(scalar * self.band, self.mesh)


class _StepOutputs:
    """Per-step outputs written into (nt, …) buffers allocated at the
    first step, on the step's device."""

    def __init__(self, nt):
        self.nt = nt
        self.buffers = None

    def put(self, k, step):
        if self.buffers is None:
            self.buffers = {name: v.new_empty((self.nt,) + tuple(v.shape))
                            for name, v in step.items()}
        for name, v in step.items():
            self.buffers[name][k] = v

    def result(self, ts, batch):
        """The reference's layout: (nt, …) for one μ; a leading μ axis,
        (B, nt, …), for a batch (its trailing axis moved to the front)."""
        if not batch:
            return dict(self.buffers, t=ts)
        out = {name: torch.movedim(v, -1, 0)
               for name, v in self.buffers.items()}
        # Per-lane clocks (nt, B) come out (B, nt), as one shared clock.
        out["t"] = ts.T if ts.ndim == 2 else ts.expand(batch + ts.shape)
        return out


class OneDimensionalSolver(ABC):
    """FEM solver for 1-D parametrized problems on (possibly) moving
    domains (reference ``fom/base.py:116-871``)."""

    DIRICHLET_ENTRY = 1.0
    DIRICHLET_VALUE = 0.0

    NX = Domain.NX
    NT = Domain.NT
    L0 = Domain.L0
    T = Domain.T

    B0 = BoundaryConditions.B0
    BL = BoundaryConditions.BL
    DB0_DT = BoundaryConditions.DB0_DT
    DBL_DT = BoundaryConditions.DBL_DT

    BDF_SCHEME = BDF.TWO

    # Whether operators integrate over the ALE-scaled domain.
    MOVING_ASSEMBLY = False
    # Whether the serial offline sweep writes per-μ runtime reports.
    RUNTIME_PROCESS = False

    def __init__(
        self,
        domain=None,
        dirichlet=None,
        parameters=None,
        forcing_term=None,
        u0=None,
        Lt=None,
        dLt_dt=None,
        filename=None,
        poly_type="P",
        degrees=1,
        project_u0=False,
        exact_solution=None,
        bdf_scheme=None,
        device="cuda",
    ) -> None:
        """As the reference's constructor, plus ``bdf_scheme`` (overrides
        the class's BDF_SCHEME) and ``device``, where :meth:`solve` and
        the sweeps step: the card unless ``device="cpu"``."""
        self.filename = filename
        self.domain = dict(domain) if domain else None
        self.dirichlet = dict(dirichlet) if dirichlet else None
        self.mu = dict(parameters) if parameters else None
        self.forcing_term = forcing_term
        self.u0 = u0
        self.Lt = Lt
        self.dLt_dt = dLt_dt
        self.poly_type = poly_type
        self.degrees = int(degrees)
        self.project_u0 = project_u0
        self.exact_solution = exact_solution
        if bdf_scheme is not None:
            self.BDF_SCHEME = str(bdf_scheme)
        self.device = device
        self.exact = None
        self.errors = None

        # The mesh exists from the start: serving assembles at entries
        # without a setup().
        self.mesh = self._make_mesh() if self.domain else None
        self.entries_dirichlet = None
        self.dofs_dirichlet = None

        self.solutions = None
        self.is_setup = False
        self._step_cache = None
        self._entry_map_cache = {}

    def _make_mesh(self):
        return Mesh1D(L0=float(self.domain[self.L0]),
                      nx=int(self.domain[self.NX]), degree=self.degrees)

    # ------------------------------------------------------------------
    # Geometry
    # ------------------------------------------------------------------
    @property
    def scale_solutions(self):
        return 1.0

    @property
    def dt(self):
        """T/nt: a float, or a (B,) tensor of per-lane steps where the
        final time is one (a batch on per-lane clocks)."""
        return self.domain[self.T] / self.domain[self.NT]

    @property
    def timesteps(self):
        return self.solutions.ts

    def scale_factor(self, mu, t):
        """ALE pull-back factor Lt(μ, t); 1.0 for fixed domains."""
        if self.Lt is None:
            return 1.0
        return self._per_step("Lt", lambda: self.Lt(t=t, **mu))

    def _per_step(self, name, fn):
        """``fn()``, evaluated once a step inside the time loop (where μ, t
        and the domain length are fixed for the step: the many assembly
        calls of a step share Lt and the boundary data), else at each
        call."""
        cache = self._step_cache
        if cache is None:
            return fn()
        if name not in cache:
            cache[name] = fn()
        return cache[name]

    # ------------------------------------------------------------------
    # Setup
    # ------------------------------------------------------------------
    def setup(self):
        """Create the static FEM structures."""
        self.mesh = self._make_mesh()
        self.find_dirichlet_entries()
        self._entry_map_cache = {}
        self.is_setup = True

    @property
    def dirichlet_dofs(self):
        """Dofs pinned by the Dirichlet convention, from which boundary
        values the problem defines (left ``b0``, right ``bL``);
        ``dirichlet=None`` pins both ends."""
        if self.dirichlet is None:
            return (0, self.mesh.nh - 1)
        dofs = []
        if self.B0 in self.dirichlet:
            dofs.append(0)
        if self.BL in self.dirichlet:
            dofs.append(self.mesh.nh - 1)
        return tuple(dofs)

    def find_dirichlet_entries(self):
        """Detect the Dirichlet entries from the assembled topology, as the
        reference does (``fom/base.py:262-287``): the μ-independent probe
        (M + A_topo)/2, unit mass plus the −u′·v + u′·v′ form, through the
        banded assembly with the convention applied; every structural
        entry equal to ``DIRICHLET_ENTRY`` counts. Host-side, float64."""
        mesh = self.mesh
        ones = torch.ones(mesh.xq_ref.shape, dtype=torch.float64)
        M = assemble_bilinear_band(mesh, ones, 0, 0, mesh.h0)
        A = (assemble_bilinear_band(mesh, ones, 1, 1, mesh.h0)
             - assemble_bilinear_band(mesh, ones, 1, 0, mesh.h0))
        K = apply_dirichlet_band((M + A) / 2.0, self.dirichlet_dofs,
                                 mesh.degree, self.DIRICHLET_ENTRY)
        rows, cols, values = band_nonzero_entries(K, mesh)
        mask = np.isclose(values, self.DIRICHLET_ENTRY)
        self.dofs_dirichlet = [(int(r),) for r in rows[mask]]
        self.entries_dirichlet = list(
            zip(rows[mask].tolist(), cols[mask].tolist()))

    def update_parametrization(self, new):
        self.mu = dict(new)

    # ------------------------------------------------------------------
    # Generic assembly drivers
    # ------------------------------------------------------------------
    @staticmethod
    def _like(mu, t=None):
        """(dtype, device) of the first tensor among t and μ's leaves; the
        compute dtype on the CPU when there is none."""
        for v in [t] + list((mu or {}).values()):
            if torch.is_tensor(v):
                return v.dtype, v.device
        return compute_dtype(), torch.device("cpu")

    @staticmethod
    def _mu_batch_shape(mu):
        """() for scalar μ, (B,) when μ's leaves are batched tensors."""
        for v in (mu or {}).values():
            if torch.is_tensor(v) and v.ndim >= 1:
                return tuple(v.shape)
        return ()

    def _as_scale(self, scale, mu, t=None):
        """``scale`` as a tensor of μ's dtype and device, broadcast to μ's
        batch shape where it is a scalar (coefficients then broadcast
        against batched parameters, as in the reference's lane layout)."""
        dtype, device = self._like(mu, t)
        if not torch.is_tensor(scale):
            scale = torch.full((), float(scale), dtype=dtype, device=device)
        bshape = self._mu_batch_shape(mu)
        if bshape and scale.ndim == 0:
            scale = scale.expand(bshape)
        return scale

    def _assembly_scale(self, mu, t):
        scale = self.scale_factor(mu, t) if self.MOVING_ASSEMBLY else 1.0
        return self._as_scale(scale, mu, t)

    def _entry_map(self, entries):
        if len(entries) == 0:
            raise ValueError(
                "an empty entry list: serving assembles at DEIM entries "
                "only (a reductor with no interpolation dofs); pass "
                "entries=None for the full band")
        key = tuple(tuple(int(v) for v in e) for e in entries)
        cached = self._entry_map_cache.get(key)
        if cached is None:
            cached = self.mesh.build_entry_map(
                key, dirichlet_dofs=self.dirichlet_dofs,
                dirichlet_entry=self.DIRICHLET_ENTRY,
                dirichlet_value=self.DIRICHLET_VALUE)
            self._entry_map_cache[key] = cached
        return cached

    def _xq(self, scale, elements=None):
        """Physical quadrature coordinates of ``elements`` (all without),
        with the scale's batch shape trailing: (n_el, Q, *scale.shape)."""
        if elements is None:
            xq = self.mesh.on(scale.dtype, scale.device).xq
        else:
            xq = torch.as_tensor(self.mesh.xq_ref[elements],
                                 dtype=scale.dtype, device=scale.device)
        return xq.reshape(xq.shape + (1,) * scale.ndim) * scale

    @staticmethod
    def _call_coeff(c, xq, elements):
        """Coefficients take (x_phys[, elements]); ``elements`` lets a
        state-dependent coefficient gather its values on the element set."""
        nargs = getattr(c, "__code__", None)
        if nargs is not None and nargs.co_argcount >= 2:
            return c(xq, elements)
        return c(xq)

    def _assemble_matrix(self, terms, mu, t, entries=None, raw_band=False):
        """Sum of bilinear terms (a, b, coeff): a banded operator for
        ``entries=None``, else the values at ``entries``."""
        scale = self._assembly_scale(mu, t)
        h = self.mesh.h0 * scale
        if entries is not None:
            emap = self._entry_map(entries)
            xq = self._xq(scale, emap.elements)
            values = _sum(
                assemble_bilinear_entries(
                    self.mesh, emap, self._call_coeff(c, xq, emap.elements),
                    a, b, h)
                for (a, b, c) in terms)
            return apply_entry_dirichlet(values, emap)
        xq = self._xq(scale)
        band = _sum(
            assemble_bilinear_band(self.mesh, self._call_coeff(c, xq, None),
                                   a, b, h)
            for (a, b, c) in terms)
        band = apply_dirichlet_band(band, self.dirichlet_dofs,
                                    self.mesh.degree, self.DIRICHLET_ENTRY)
        if raw_band:
            return band
        return BandedOperator(band, self.mesh)

    def _assemble_vector(self, terms, mu, t, entries=None):
        """Sum of linear terms (b, coeff): the global vector for
        ``entries=None``, else the values at ``entries``."""
        scale = self._assembly_scale(mu, t)
        h = self.mesh.h0 * scale
        if entries is not None:
            emap = self._entry_map(entries)
            xq = self._xq(scale, emap.elements)
            values = _sum(
                assemble_linear_entries(
                    self.mesh, emap, self._call_coeff(c, xq, emap.elements),
                    b, h)
                for (b, c) in terms)
            return apply_entry_dirichlet(values, emap)
        xq = self._xq(scale)
        vec = _sum(
            assemble_linear_vector(self.mesh, self._call_coeff(c, xq, None),
                                   b, h)
            for (b, c) in terms)
        return apply_dirichlet_vector(vec, self.dirichlet_dofs,
                                      self.DIRICHLET_VALUE)

    # ------------------------------------------------------------------
    # Operators (subclasses override/extend)
    # ------------------------------------------------------------------
    def assemble_mass(self, mu, t, entries=None):
        """Mass operator u·v."""
        one = lambda x: torch.ones_like(x)
        return self._assemble_matrix([(0, 0, one)], mu, t, entries)

    @abstractmethod
    def assemble_stiffness(self, mu=None, t=None, entries=None):
        ...

    def assemble_convection(self, mu=None, t=None, entries=None):
        pass

    @abstractmethod
    def assemble_forcing(self, mu, t, entries=None):
        ...

    @abstractmethod
    def assemble_lifting(self, mu, t, entries=None):
        ...

    @abstractmethod
    def assemble_system(self, mu, t, bdf=1.0, u_n=None, u_n1=None):
        """Return (Mh, Kh) for the BDF step."""
        ...

    @abstractmethod
    def assemble_system_rhs(self, mu, t, Mh_mat, u_n, u_n1=None):
        ...

    def assemble_local(self, form_terms, entries, mu=None, t=None,
                       is_vector=False):
        """Per-entry assembly API of the reference."""
        if is_vector:
            return self._assemble_vector(form_terms, mu, t, entries=entries)
        return self._assemble_matrix(form_terms, mu, t, entries=entries)

    # ------------------------------------------------------------------
    # Lifting
    # ------------------------------------------------------------------
    def _dirichlet_value(self, key, mu, t, L, dLt_dt=0.0):
        fn = self.dirichlet[key]
        if callable(fn):
            return self._per_step(key, lambda: fn(t=t, L=L, dLt_dt=dLt_dt,
                                                  **mu))
        return fn

    def create_lifting_operator(self, mu, t, L, only_g=False):
        """Lifting g, dg/dt, ∇g as callables of physical x, with the
        moving-boundary correction of dg/dt when ``dLt_dt`` is defined."""
        b0 = self._dirichlet_value(self.B0, mu, t, L)
        bL = self._dirichlet_value(self.BL, mu, t, L)

        def g(x):
            return bL * (x / L) + b0 * (L - x) / L

        if only_g:
            return g

        if self.dLt_dt:
            L0 = self.domain[self.L0]
            dLt_dt_val = self.dLt_dt(t=t, **mu) * L0
            db0 = self._dirichlet_value(self.DB0_DT, mu, t, L,
                                        dLt_dt=dLt_dt_val)
            dbL = self._dirichlet_value(self.DBL_DT, mu, t, L,
                                        dLt_dt=dLt_dt_val)

            def dg_dt(x):
                linear = dbL * (x / L) + db0 * (L - x) / L
                moving = (b0 - bL) * (x / L) * (dLt_dt_val / L)
                return linear + moving

        else:
            db0 = self._dirichlet_value(self.DB0_DT, mu, t, L, dLt_dt=0.0)
            dbL = self._dirichlet_value(self.DBL_DT, mu, t, L, dLt_dt=0.0)

            def dg_dt(x):
                return dbL * (x / L) + db0 * (L - x) / L

        grad_g = (bL - b0) / L
        return g, dg_dt, grad_g

    # ------------------------------------------------------------------
    # Interpolation / evaluation
    # ------------------------------------------------------------------
    def interpolate_func(self, g, V=None, mu=None, t=None):
        """Interpolate a callable onto the dof grid; moving solvers
        evaluate at the scaled coordinates."""
        return self._eval_field(g, _dofs_at(self.mesh,
                                            self._assembly_scale(mu, t)),
                                mu, t)

    def _eval_field(self, fn, x, mu, t):
        if callable(fn):
            return fn(x, t=t, **(mu or {}))
        return torch.full_like(x, float(fn))

    def _project_field(self, fn, mu, scale):
        """L2 projection of a callable (at t = 0) onto the FE space."""
        h = self.mesh.h0 * scale
        xq = self._xq(scale)
        t0 = torch.zeros((), dtype=scale.dtype, device=scale.device)
        rhs = assemble_linear_vector(self.mesh,
                                     self._eval_field(fn, xq, mu, t0), 0, h)
        M = assemble_bilinear_band(self.mesh, torch.ones_like(xq), 0, 0, h)
        return self._solve_band(M, rhs)

    def _solve_band(self, band, rhs):
        """Solve with a trailing-batch band (2p+1, nh, ...) and rhs (nh,
        ...): the banded solve sees the batch as leading axes (views)."""
        x = solve_banded(torch.movedim(band, (0, 1), (-2, -1)),
                         torch.movedim(rhs, 0, -1), self.mesh.degree)
        return torch.movedim(x, -1, 0)

    # ------------------------------------------------------------------
    # Time integration
    # ------------------------------------------------------------------
    def _compute_device(self):
        """The device the solves step on; raises where it is the card and
        there is none (no path carries on on the CPU)."""
        device = torch.device(self.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the FOM steps on the card unless the "
                "solver is built with device='cpu'")
        return device

    def _initial_condition(self, mu):
        dtype, device = self._like(mu)
        t0 = torch.zeros((), dtype=dtype, device=device)
        scale0 = self._assembly_scale(mu, t0)
        x0 = _dofs_at(self.mesh, scale0)
        u_init = self._eval_field(self.u0, x0, mu, t0)
        if self.project_u0:
            # L2 projection instead of interpolation: solve M c = ∫ u0 v.
            u_init = self._project_field(self.u0, mu, scale0)
        g0 = self.create_lifting_operator(
            mu=mu, t=t0, L=self.domain[self.L0] * scale0, only_g=True)
        return u_init - g0(x0)

    def _mu_array(self, mu, device=None):
        """μ as 0-d tensors in the compute dtype on ``device``, keys
        sorted."""
        return {k: torch.tensor(float(mu[k]), dtype=compute_dtype(),
                                device=device)
                for k in sorted(mu.keys())}

    def _timesteps(self, nt, dtype, device):
        """t_k = (k+1)·dt in the compute dtype, dt rounded to it first
        (the reference's ``(k + 1).astype(dtype) * dt``): (nt,), or
        (nt, B) where the final time is a (B,) tensor of per-lane times
        (``parallel.solve_fom_batch(..., dilations=...)``)."""
        dt = torch.as_tensor(self.dt, dtype=dtype, device=device)
        steps = torch.arange(1, nt + 1, dtype=dtype, device=device)
        return steps * dt if dt.ndim == 0 else steps[:, None] * dt

    @contextlib.contextmanager
    def _time_loop(self):
        """The time loop's scope: its assembly calls (the reference's
        traced calls) record nothing on the host and share one step cache
        (:meth:`_per_step`), which the loop clears at every step."""
        self._step_cache = {}
        try:
            yield self._step_cache
        finally:
            self._step_cache = None

    def _step_outputs(self, mu, t, uh, uc, scale):
        """Per-step auxiliary outputs (probes etc.)."""
        return {}

    def _step_extras(self, mu, t, u_n, u_n1):
        """Pre-solve per-step outputs (e.g. nonlinear operator snapshots)."""
        return {}

    def _lifted(self, mu, t, uh):
        """(x_phys, scale, uh + g(x_phys)) at step time t."""
        scale = self._as_scale(self.scale_factor(mu, t) if self.Lt else 1.0,
                               mu, t)
        L = self.domain[self.L0] * scale
        x_phys = _dofs_at(self.mesh, scale)
        g = self.create_lifting_operator(mu=mu, t=t, L=L, only_g=True)
        return x_phys, scale, uh + g(x_phys)

    def _step_record(self, mu, t, uh, uc, x_phys, scale, extras):
        step = dict(uh=uh, uc=uc, x=x_phys)
        step.update(extras)
        step.update(self._step_outputs(mu, t, uh, uc, scale))
        if self.exact_solution is not None:
            ue_h = self._eval_field(self.exact_solution, x_phys, mu, t)
            step["exact"] = ue_h
            step["error"] = norm_L2(uc - ue_h, self.mesh)
        return step

    def _solve_impl(self, mu):
        """The BDF time loop (reference ``fom/base.py:536-592``): μ's
        leaves 0-d (outputs (nt, …)) or (B,) (outputs (B, nt, …)), on the
        step device. With ``self.dd_sweep`` set, runs the compensated
        loop (:meth:`_solve_impl_dd`) instead. Float32 contractions must
        be at full precision (:func:`dtypes.full_f32_matmul`)."""
        if getattr(self, "dd_sweep", False):
            return self._solve_impl_dd(mu)
        require_full_f32_matmul()
        nt = int(self.domain[self.NT])
        bdf2 = self.BDF_SCHEME == BDF.TWO
        ts = self._timesteps(nt, *self._like(mu))

        u_n = self._initial_condition(mu)
        # Under BDF-2 the history starts as a zero vector.
        u_n1 = torch.zeros_like(u_n)
        outs = _StepOutputs(nt)
        with self._time_loop() as step_cache:
            for k in range(nt):
                step_cache.clear()
                t = ts[k]
                bdf = 1.5 if (bdf2 and k > 0) else 1.0
                hist = u_n1 if bdf2 else None
                Mh, Kh = self.assemble_system(mu, t, bdf, u_n, hist)
                bh = self.assemble_system_rhs(mu, t, Mh, u_n, hist)
                extras = self._step_extras(mu, t, u_n, hist)
                uh = self._solve_band(Kh.band, bh)
                x_phys, scale, uc = self._lifted(mu, t, uh)
                outs.put(k, self._step_record(mu, t, uh, uc, x_phys, scale,
                                              extras))
                u_n, u_n1 = uh, u_n
        return outs.result(ts, self._mu_batch_shape(mu))

    def _solve_impl_dd(self, mu):
        """Residual-form double-word time loop (reference
        ``fom/base.py:594-705``): the same step algebra,

            u_pred = 2uₙ − uₙ₋₁              (dd extrapolation)
            r0     = M·(uₙ₋₁−uₙ) + dt·f_g − (K·u_pred − bdf·M·u_pred)
            K·δ    = r0,   u = u_pred ⊕ δ    (dd accumulation)

        with the state carried as an unevaluated (hi, lo) sum, so float32
        rounding enters only relative to the step's increment. Eager torch
        rounds each op on its own, which the error-free transformations
        need (no ``torch.compile`` here). Extra output ``uh_lo``, the low
        words."""
        require_full_f32_matmul()
        nt = int(self.domain[self.NT])
        bdf2 = self.BDF_SCHEME == BDF.TWO
        p = self.mesh.degree
        ts = self._timesteps(nt, *self._like(mu))

        u_h = self._initial_condition(mu)
        zeros = torch.zeros_like(u_h)
        u_l, u1_h, u1_l = zeros, zeros, zeros
        outs = _StepOutputs(nt)
        with self._time_loop() as step_cache:
            for k in range(nt):
                step_cache.clear()
                t = ts[k]
                bdf = 1.5 if (bdf2 and k > 0) else 1.0
                if bdf2:
                    up_h, up_l = dd_bdf2_predict(u_h, u_l, u1_h, u1_l)
                else:
                    up_h, up_l = u_h, u_l
                # u*(trilinear) must equal u_pred: (u_pred, u_pred) makes
                # 2uₙ−uₙ₋₁ collapse to u_pred inside assemble_system.
                Mh, Kh = self.assemble_system(mu, t, bdf, up_h,
                                              up_h if bdf2 else None)
                extras = self._step_extras(mu, t, u_h,
                                           u1_h if bdf2 else None)
                Mb, Kb = Mh.band, Kh.band
                # dt·f_g exactly: the M-history terms drop with zero states.
                f_vec = self.assemble_system_rhs(mu, t, Mh, zeros,
                                                 zeros if bdf2 else None)
                # M·(uₙ₋₁ − uₙ): zero under BDF-1 and at the BDF-2 start.
                if bdf2 and k > 0:
                    r_M = band_matvec(Mb, dd_history_diff(u_h, u_l, u1_h,
                                                          u1_l), p)
                else:
                    r_M = zeros
                Ku = band_matvec(Kb, up_h, p) + band_matvec(Kb, up_l, p)
                Mu = band_matvec(Mb, up_h, p) + band_matvec(Mb, up_l, p)
                r0 = r_M + f_vec - (Ku - bdf * Mu)

                delta = self._solve_band(Kb, r0)
                nh_h, nh_l = dd_add_small(up_h, up_l, delta)

                x_phys, scale, uc = self._lifted(mu, t, nh_h)
                step = self._step_record(mu, t, nh_h, uc, x_phys, scale,
                                         extras)
                step["uh_lo"] = nh_l
                outs.put(k, step)
                u_h, u_l, u1_h, u1_l = nh_h, nh_l, u_h, u_l
        return outs.result(ts, self._mu_batch_shape(mu))

    def solve(self):
        """Integrate the problem in time for ``self.mu`` on the solver's
        device; fills ``self.solutions`` (nh, nt) as the reference does. A
        dd sweep's trajectory is its hi and lo words recombined in
        float64 on the host."""
        mu = self.mu
        device = self._compute_device()
        outs = self._solve_native(mu)
        if outs is None:
            with full_f32_matmul(), torch.no_grad():
                got = self._solve_impl(self._mu_array(mu, device))
            outs = {k: v.cpu().numpy() for k, v in got.items()}

        ts = outs["t"]
        snapshots = outs["uh"].T  # (nh, nt)
        fom = outs["uc"].T
        if "uh_lo" in outs:
            lo = outs["uh_lo"].T.astype(np.float64)
            snapshots = snapshots.astype(np.float64) + lo
            fom = fom.astype(np.float64) + lo
        domain_x = outs["x"].T

        self.solutions = SolutionsStorage(ts=ts, mu=mu, domain=domain_x,
                                          fom=fom, snapshots=snapshots)
        self.domain_x = domain_x

        if self.exact_solution is not None:
            self._exact = outs["exact"].T
            self.errors = dict(zip(ts, outs["error"]))
            self.exact = {t: outs["exact"][i] for i, t in enumerate(ts)}

        self._collect_runtime_outputs(outs)
        return self.solutions

    def _solve_native(self, mu):
        """Native fast-path hook: the ``_solve_impl`` output dict (numpy)
        or None. The port has no native loop yet: always None."""
        return None

    def _collect_runtime_outputs(self, outs):
        """Hook for subclasses to harvest the loop's outputs."""
        pass

    def dump_solutions(self, name):
        self.solutions.to_pickle(name)

    # ------------------------------------------------------------------
    # Dof/cell maps (API parity)
    # ------------------------------------------------------------------
    def build_cell_to_dofs(self):
        """Cell → dof map."""
        self.cell_to_dofs = {e: self.mesh.cell_dofs(e)
                             for e in range(self.mesh.ne)}
        return self.cell_to_dofs

    def build_dofs_to_cells(self):
        """Dof → cells map."""
        self.dof_to_cells = {d: self.mesh.dof_cells(d)
                             for d in range(self.mesh.nh)}
        return self.dof_to_cells

    # ------------------------------------------------------------------
    # Errors and point evaluation
    # ------------------------------------------------------------------
    def _compute_error(self, u, ue, norm_type="L2"):
        """Error norms as ``fenics.errornorm`` with degree_rise=0."""
        e = torch.as_tensor(np.asarray(u)) - torch.as_tensor(np.asarray(ue))
        if norm_type == "max":
            return float(torch.max(torch.abs(e)))
        if norm_type == "L2":
            return float(norm_L2(e, self.mesh))
        if norm_type == "H1":
            return float(norm_H1(e, self.mesh))
        raise ValueError(f"Unknown norm type {norm_type}.")

    def evaluate_at(self, u, x_points, scale=1.0):
        return eval_function_at(torch.as_tensor(u), x_points, self.mesh,
                                scale=scale)
