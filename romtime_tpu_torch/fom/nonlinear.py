"""One-dimensional isentropic gas dynamics, the moving-piston Burgers
model (counterpart of ``romtime_tpu/fom/nonlinear.py``):

    u_t + (a0 + w)·u′ + b0·u·u′ + lifting couplings − α·u″ = 0

on a cylinder closed by an oscillating piston: right-boundary-only
Dirichlet data, a one-sided lifting, BDF-2 with the u* = 2uₙ − uₙ₋₁
extrapolation of the trilinear term, the per-step nonlinear-operator
snapshots (N-MDEIM's training data), physical probes and mass
conservation. Operators assemble over the full band or at DEIM entries
(``fom/base.py``).
"""

import numpy as np
import torch

from ..conventions import (
    BDF,
    MassConservation,
    OneDimensionalBurgersConventions,
    PistonParameters,
    ProblemType,
)
from ..ops.assembly import (
    _at_quad,
    _function_at_quad,
    _gather_cell_dofs,
    _trailing,
    eval_function_at,
)
from ..utils.io import dump_csv, write_table
from .base import BandedOperator, OneDimensionalSolver, move_mesh
from .utils import compute_time_between_peaks, find_first_positive_peak


class OneDimensionalBurgers(OneDimensionalSolver):
    """Moving-piston gas dynamics solver."""

    ALPHA = 1e-10   # artificial viscosity
    GAMMA = 1.4     # heat capacity ratio

    MOVING_ASSEMBLY = True
    BDF_SCHEME = BDF.TWO
    # The serial offline sweep writes each μ's probe CSV.
    RUNTIME_PROCESS = True

    def __init__(
        self,
        domain: dict,
        dirichlet: dict,
        parameters: dict = None,
        forcing_term=None,
        u0=None,
        filename=None,
        degrees=1,
        project_u0=False,
        exact_solution=None,
        Lt=None,
        dLt_dt=None,
        probe_locations=(0.0, 0.5),
        bdf_scheme=None,
        device="cuda",
    ) -> None:
        super().__init__(
            domain=domain, dirichlet=dirichlet, parameters=parameters,
            forcing_term=forcing_term, u0=u0, filename=filename,
            degrees=degrees, project_u0=project_u0,
            exact_solution=exact_solution, Lt=Lt, dLt_dt=dLt_dt,
            bdf_scheme=bdf_scheme, device=device)
        self.probe_location = list(probe_locations)
        self.probes = None
        self.nonlinear_snapshots = None
        self._nonlinear_topology = None
        self._topology_index = {}
        self._probe_points = {}

    # ------------------------------------------------------------------
    # Physical scalings
    # ------------------------------------------------------------------
    @property
    def scale_solutions(self):
        return self.mu[OneDimensionalBurgersConventions.A0]

    @property
    def system_forcing(self):
        """Piston Mach number δω/a0."""
        mu = self.mu
        return (mu[PistonParameters.DELTA] * mu[PistonParameters.OMEGA]
                / mu[PistonParameters.A0])

    @property
    def nonlinearity(self):
        """(u_p, eta): forcing magnitude and linearity measure from the
        probes' peak timing (scipy's ``find_peaks``)."""
        from scipy.signal import find_peaks

        probe_L = np.array(self.probes[0])
        probe_piston = np.array(self.probes[2])

        peaks_L = find_peaks(np.abs(probe_L))[0]
        peaks_piston = find_peaks(np.abs(probe_piston))[0]

        indices_L = find_first_positive_peak(probe_L, peaks_L)
        indices_piston = find_first_positive_peak(probe_piston, peaks_piston)

        ts = self.timesteps
        T0 = compute_time_between_peaks(ts, indices_piston)
        T = compute_time_between_peaks(ts, indices_L)
        return self.system_forcing, T / T0

    def nonlinear_coefficient(self, mu):
        """b0 = (γ+1)/2 · a0."""
        return (self.GAMMA + 1.0) / 2.0 * mu[OneDimensionalBurgersConventions.A0]

    def create_diffusion_coefficient(self, mu=None):
        """Artificial viscosity α."""
        return self.ALPHA

    def compute_mesh_velocity(self, mu, t):
        """w(x) = x·L̇t/Lt."""
        dLt_dt = self._per_step("dLt_dt", lambda: self.dLt_dt(t=t, **mu))
        Lt = self.scale_factor(mu, t)
        return lambda x: x * dLt_dt / Lt

    # ------------------------------------------------------------------
    # Boundary handling: right-only Dirichlet (the BC dict defines only
    # bL, so the base derivation pins dof nh-1), one-sided lifting.
    # ------------------------------------------------------------------
    def create_lifting_operator(self, mu, t, L, only_g=False):
        """One-sided lifting g = bL·x/L."""
        bL = self._dirichlet_value(self.BL, mu, t, L)

        def g(x):
            return bL * (x / L)

        if only_g:
            return g
        dbL = self._dirichlet_value(self.DBL_DT, mu, t, L)

        def dg_dt(x):
            return dbL * (x / L)

        return g, dg_dt, bL / L

    # ------------------------------------------------------------------
    # Setup: probes + nonlinear-snapshot topology
    # ------------------------------------------------------------------
    def setup(self):
        super().setup()
        self.nonlinear_snapshots = list()
        self.probe_location = [0.0, 0.5]
        self.probes = {idx: list() for idx in range(len(self.probe_location)
                                                    + 1)}

        # The fixed topology of the per-step trilinear snapshot: probe with
        # the non-constant state u = x so every structural entry is live,
        # with the mesh motion bypassed (the pattern does not depend on
        # the scale); float64 on the host, tolerance 1e-15.
        f64 = torch.float64
        mu_probe = {OneDimensionalBurgersConventions.A0:
                    torch.tensor(1.0, dtype=f64)}
        x_state = torch.as_tensor(self.mesh.x_dofs, dtype=f64)
        Lt_saved, dLt_saved = self.Lt, self.dLt_dt
        self.Lt = self.dLt_dt = None
        try:
            Nh_op = self.assemble_trilinear(
                mu=mu_probe, t=torch.tensor(0.0, dtype=f64), u_n=x_state)
        finally:
            self.Lt, self.dLt_dt = Lt_saved, dLt_saved
        rows, cols, _ = Nh_op.nonzero_entries(tolerance=1e-15)
        self._nonlinear_topology = (rows, cols)
        self._topology_index = {}

    def _nonlinear_data(self, band):
        """The trilinear band's values on the snapshot topology, (nnz,
        ...), by one gather with an index cached per device."""
        idx = self._topology_index.get(band.device)
        if idx is None:
            rows, cols = self._nonlinear_topology
            flat = (cols - rows + self.mesh.degree) * self.mesh.nh + rows
            idx = torch.as_tensor(flat, device=band.device)
            self._topology_index[band.device] = idx
        return band.reshape((-1,) + tuple(band.shape[2:]))[idx]

    # ------------------------------------------------------------------
    # Unified BDF system
    # ------------------------------------------------------------------
    def assemble_system(self, mu, t, bdf=1.0, u_n=None, u_n1=None):
        """K = bdf·M + dt·(A + B + N(u*) + N̂) with u* = 2uₙ − uₙ₋₁. A call
        outside the time loop also records the nonlinear snapshot, as the
        reference's eager calls do."""
        Mh = self.assemble_mass(mu=mu, t=t)
        Ah = self.assemble_stiffness(mu=mu, t=t)
        Chat = self.assemble_nonlinear_lifting(mu=mu, t=t)
        Bh = self.assemble_convection(mu=mu, t=t)
        Nh = self._trilinear_step(mu, t, u_n, u_n1)

        dt = self.dt
        Kh_band = bdf * Mh.band + dt * (Ah.band + Bh.band + Nh.band
                                        + Chat.band)

        if self.nonlinear_snapshots is not None and self._step_cache is None:
            self.nonlinear_snapshots.append(
                self._nonlinear_data(Nh.band).cpu().numpy())

        return Mh, BandedOperator(Kh_band, self.mesh)

    def assemble_system_rhs(self, mu, t, Mh_mat, u_n, u_n1=None):
        """b = M·(2uₙ − ½uₙ₋₁) + dt·f_g."""
        fgh = self.assemble_lifting(mu=mu, t=t)
        if u_n1 is None:
            bdf_term = Mh_mat.dot(u_n)
        else:
            bdf_term = Mh_mat.dot(2.0 * u_n - 0.5 * u_n1)
        return bdf_term + self.dt * fgh

    # ------------------------------------------------------------------
    # LHS operators
    # ------------------------------------------------------------------
    @move_mesh
    def assemble_stiffness(self, mu, t, entries=None):
        """α ∇u·∇v (artificial viscosity)."""
        alpha = self.create_diffusion_coefficient(mu)
        coeff = lambda x: alpha * torch.ones_like(x)
        return self._assemble_matrix([(1, 1, coeff)], mu, t, entries)

    @move_mesh
    def assemble_convection(self, mu, t, entries=None):
        """−(a0 + w)·u′·v."""
        a0 = mu[OneDimensionalBurgersConventions.A0]
        w = self.compute_mesh_velocity(mu=mu, t=t)
        coeff = lambda x: -(a0 + w(x))
        return self._assemble_matrix([(1, 0, coeff)], mu, t, entries)

    def _state_at_quadrature(self, u_n):
        """The FE state at the quadrature points as c(x, elements), with
        x's trailing axes: ``u_n`` a dof vector (nh, ...), or a factorized
        state ``(V, coeff)``, u = V·coeff, whose basis rows are gathered
        on the needed elements only (O(entries·N) a call)."""
        p = self.mesh.degree
        idx_full = (p * np.arange(self.mesh.ne)[:, None]
                    + np.arange(p + 1)[None, :])

        def at_quad(u_loc, x):
            B0 = self.mesh.on(x.dtype, x.device).B0
            return _trailing(_at_quad(u_loc, B0), x.ndim)

        if isinstance(u_n, tuple):
            V, coeff = u_n
            V = np.asarray(V)

            def at(x, elements=None):
                idx = idx_full if elements is None else idx_full[elements]
                V_loc = torch.as_tensor(V[idx], dtype=x.dtype,
                                        device=x.device)     # (e, p+1, N)
                u_loc = torch.tensordot(V_loc, coeff.to(x), dims=([2], [0]))
                return at_quad(u_loc, x)

            return at

        u_n = torch.as_tensor(u_n)

        def at(x, elements=None):
            u = u_n.to(device=x.device, dtype=x.dtype)
            u_loc = (_gather_cell_dofs(u, self.mesh) if elements is None
                     else u[torch.as_tensor(idx_full[elements],
                                            device=x.device)])
            return at_quad(u_loc, x)

        return at

    @move_mesh
    def assemble_trilinear(self, mu, t, entries=None, u_n=None):
        """b0·uₙ·u′·v."""
        b0 = self.nonlinear_coefficient(mu)
        u_at = self._state_at_quadrature(u_n)
        coeff = lambda x, elements: b0 * u_at(x, elements)
        return self._assemble_matrix([(1, 0, coeff)], mu, t, entries)

    @move_mesh
    def assemble_nonlinear(self, mu, t, entries=None, u_n=None):
        """b0·uₙ·cos(x+1)·u′·v, the N-MDEIM experiment's variant."""
        b0 = self.nonlinear_coefficient(mu)
        u_at = self._state_at_quadrature(u_n)
        coeff = lambda x, elements: b0 * u_at(x, elements) * torch.cos(x + 1.0)
        return self._assemble_matrix([(1, 0, coeff)], mu, t, entries)

    @move_mesh
    def assemble_nonlinear_lifting(self, mu, t, entries=None):
        """b0·(g·u′ + g′·u)·v."""
        scale = self._assembly_scale(mu, t)
        L = self.domain[self.L0] * scale
        g, _, grad_g = self.create_lifting_operator(mu=mu, t=t, L=L)
        b0 = self.nonlinear_coefficient(mu)
        terms = [
            (1, 0, lambda x: b0 * g(x)),
            (0, 0, lambda x: b0 * grad_g * torch.ones_like(x)),
        ]
        return self._assemble_matrix(terms, mu, t, entries)

    # ------------------------------------------------------------------
    # RHS operators
    # ------------------------------------------------------------------
    @move_mesh
    def assemble_forcing(self, mu, t, entries=None):
        """f·v (unused for the piston)."""
        coeff = lambda x: self._eval_field(self.forcing_term, x, mu, t)
        return self._assemble_vector([(0, coeff)], mu, t, entries)

    @move_mesh
    def assemble_lifting(self, mu, t, entries=None):
        """−(ġ + b0·g·g′)·v + (a0+w)·g′·v − α·g′·v′."""
        scale = self._assembly_scale(mu, t)
        L = self.domain[self.L0] * scale
        g, dg_dt, grad_g = self.create_lifting_operator(mu=mu, t=t, L=L)
        b0 = self.nonlinear_coefficient(mu)
        a0 = mu[OneDimensionalBurgersConventions.A0]
        w = self.compute_mesh_velocity(mu=mu, t=t)
        alpha = self.create_diffusion_coefficient(mu)
        terms = [
            (0, lambda x: (-(dg_dt(x) + b0 * g(x) * grad_g)
                           + (a0 + w(x)) * grad_g)),
            (1, lambda x: -alpha * grad_g * torch.ones_like(x)),
        ]
        return self._assemble_vector(terms, mu, t, entries)

    def assemble_rhs(self, mu, t, entries=None):
        """RHS = lifting only (no forcing for the piston)."""
        return self.assemble_lifting(mu=mu, t=t, entries=entries)

    def _solve_native(self, mu):
        """The native float64 loop (``fom/native_sweep.py``) where this
        solver is eligible, else None."""
        from .native_sweep import outputs_native

        return outputs_native(self, mu)

    # ------------------------------------------------------------------
    # Time-loop hooks: nonlinear snapshots + probes
    # ------------------------------------------------------------------
    def _trilinear_step(self, mu, t, u_n, u_n1):
        """N(u*) with u* = 2uₙ − uₙ₋₁ (uₙ without a history). Within a
        step of the plain loop the system and the snapshot pass the same
        states and share one assembly; the dd loop passes others."""
        def assemble():
            u_star = u_n if u_n1 is None else 2.0 * u_n - u_n1
            return self.assemble_trilinear(mu=mu, t=t, u_n=u_star)

        return self._per_step(("trilinear", id(u_n), id(u_n1)), assemble)

    def _step_extras(self, mu, t, u_n, u_n1):
        Nh = self._trilinear_step(mu, t, u_n, u_n1)
        return {"nonlinear_data": self._nonlinear_data(Nh.band)}

    def _step_outputs(self, mu, t, uh, uc, scale):
        # Probed at material coordinates (the mesh at its reference
        # position): scale 1.
        key = (uc.dtype, uc.device)
        locs = self._probe_points.get(key)
        if locs is None:
            locs = torch.tensor(self.probe_location, dtype=uc.dtype,
                                device=uc.device)
            self._probe_points[key] = locs
        vals = eval_function_at(uc, locs, self.mesh, scale=1.0)
        return {"probes": torch.cat([vals, uc[-1][None]])}

    def _collect_runtime_outputs(self, outs):
        if "nonlinear_data" in outs:
            self.nonlinear_snapshots = [row for row in outs["nonlinear_data"]]
        if "probes" in outs:
            probes = outs["probes"]  # (nt, n_probes)
            self.probes = {i: list(probes[:, i])
                           for i in range(probes.shape[1])}

    # ------------------------------------------------------------------
    # Isentropic relations / mass conservation
    # ------------------------------------------------------------------
    @staticmethod
    def compute_rho(u, gamma):
        """ρ = (1 − (γ−1)/2·u)^(2/(γ−1))."""
        A = (gamma - 1.0) / 2.0
        exp = 2.0 / (gamma - 1.0)
        return (1.0 - A * u) ** exp

    @staticmethod
    def compute_p(u, gamma):
        """p = (1 − (γ−1)/2·u)^(2γ/(γ−1))."""
        A = (gamma - 1.0) / 2.0
        exp = 2.0 * (gamma / (gamma - 1.0))
        return (1.0 - A * u) ** exp

    def compute_mass_conservation(self, mu, ts, solutions, which):
        """∫ρ dx, its time derivative and the piston outflow, step by step
        on the host in float64 (``solutions`` (nt, nh))."""
        gamma = self.GAMMA
        f64 = torch.float64
        wq = self.mesh.on(f64, "cpu").w
        mu_t = {k: torch.tensor(float(v), dtype=f64) for k, v in mu.items()}
        origin = torch.zeros(1, dtype=f64)

        mass = []
        outflow = []
        for t, u in zip(ts, np.asarray(solutions)):
            u = torch.as_tensor(u, dtype=f64)
            scale = self.scale_factor(mu_t, torch.tensor(float(t), dtype=f64))
            h = self.mesh.h0 * scale
            rho_eq = self.compute_rho(_function_at_quad(u, self.mesh), gamma)
            mass.append(float(h * torch.sum(wq[None, :] * rho_eq)))

            u0 = float(eval_function_at(u, origin, self.mesh, scale=scale)[0])
            rho0 = self.compute_rho(u0, gamma=gamma)
            outflow.append(rho0 * u0)

        mass = np.array(mass)
        outflow = np.array(outflow)
        mass_change = np.gradient(mass, self.dt, edge_order=2)
        outflow = outflow * mu[OneDimensionalBurgersConventions.A0]

        return {
            MassConservation.WHICH: which,
            MassConservation.TIMESTEPS: ts,
            MassConservation.MASS: mass,
            MassConservation.MASS_CHANGE: mass_change,
            MassConservation.OUTFLOW: outflow,
        }

    # ------------------------------------------------------------------
    # Reports
    # ------------------------------------------------------------------
    def save_probes(self, name=None):
        """The probe time series in physical units (scaled by a0), column
        per location (0.0, 0.5, "L"); with ``name``, written as the
        reference's pandas CSV (index ``timesteps``)."""
        locations = list(self.probe_location) + ["L"]
        table = {loc: np.asarray(self.probes[i]) * self.scale_solutions
                 for i, loc in enumerate(locations)}
        if name is not None:
            write_table(name, table, self.timesteps,
                        index_name=MassConservation.TIMESTEPS)
        return table

    def save_mass_conservation(self, name):
        """The FOM run's mass-conservation CSV."""
        output = self.compute_mass_conservation(
            mu=self.mu, ts=self.timesteps, solutions=self.solutions.fom.T,
            which=ProblemType.FOM)
        dump_csv(name, obj=output)
        return output
