"""Discrete Empirical Interpolation (DEIM) of parametrized vectors
(counterpart of ``romtime_tpu/deim/deim.py``).

Two ways to make a reductor:

- trained, the reference's form ``DiscreteEmpiricalInterpolation(
  assemble, grid, tree_walk_params, name)``, then ``setup(rnd)`` and
  ``run(...)`` (or ``load_fom_basis``): the tree walk assembles the
  snapshots of each μ over the whole time grid in one call on the owning
  solver's device (the card unless it was built with ``device="cpu"``;
  the time grid rides as the assembly's trailing batch axis, where the
  reference vmaps), PODs them on the host in float64 (``rom.pod.orth``),
  and selects the interpolation dofs by the greedy recursion in float64
  numpy (``deim.py:60-88``; the port has no native library);
- serving, from a trained reductor's dofs alone
  (``assemble=..., dofs=..., PT_U=..., basis_rom=...``), as
  ``rom.rom.make_reductors`` builds them from a payload.

Either serves: ``_entries_traced`` gathers the local assembly at the
interpolation dofs, which the windowed engines and the global kernels
stream against folded combine tensors; the global lanes engine pairs
θ(μ, t) with a combine matrix as the reference does
(``deim.py:379-452``): under float32 serving the raw entries with the
folded V·(PᵀU)⁻¹, in float64 the PᵀU solve with the collateral basis.
The offline methods (``setup``, ``run``, ``evaluate``) run in
:data:`OFFLINE_DTYPE`, float64, whatever the serving dtype.
"""

import functools
from copy import deepcopy

import numpy as np
import torch

from ..conventions import EmpiricalInterpolation, RomParameters, Stage
from ..dtypes import compute_dtype, compute_dtype_scope
from ..ops.linalg import solve_small
from ..rom.base import Reductor
from ..rom.pod import orth
from ..utils import dump_pickle, read_pickle

#: The dtype of every offline build step of the port.
OFFLINE_DTYPE = torch.float64

#: Greedy ties: positions within this relative distance of the largest
#: |residual| count as tied, and the first of them is taken.
TIE_RTOL = 1e-10


def offline(method):
    """Run ``method`` under ``compute_dtype_scope(OFFLINE_DTYPE)``."""
    @functools.wraps(method)
    def wrapped(*args, **kwargs):
        with compute_dtype_scope(OFFLINE_DTYPE):
            return method(*args, **kwargs)

    return wrapped


def basis_vector(size, index):
    """Canonical basis column e_index (reference ``deim.py:18-22``)."""
    ej = np.zeros((size, 1))
    ej[index, 0] = 1.0
    return ej


def greedy_interpolation_points(Vf, forbidden=None):
    """Greedy DEIM point selection (reference ``deim.py:38-88``): per
    basis vector, the dof maximizing the residual of the current
    interpolant, the positions in ``forbidden`` (Dirichlet-convention
    entries, whose basis values are zero) masked out of the argmax. The
    reference's numpy recursion in float64; returns (dofs, P).

    A stated departure: the argmax takes the first position within
    :data:`TIE_RTOL` of the largest |residual|. The reference's
    ``np.argmax`` takes the first exact maximum, so among entries equal
    up to rounding (the rank-1 mass and stiffness families, whose
    interior diagonals are all alike) its pick follows the SVD's
    rounding; the port's does not, and builds on the card and on the CPU
    pick the same dofs. Where the reference's tie is exact, both take
    its first position."""
    Vf = np.asarray(Vf, dtype=np.float64)
    Nh, Ns = Vf.shape
    mask = np.zeros((Nh, 1), dtype=bool)
    if forbidden is not None and len(forbidden):
        mask[np.asarray(forbidden, dtype=int)] = True

    def masked_argmax(v):
        a = np.where(mask, -np.inf, np.abs(v)).ravel()
        return int(np.flatnonzero(a >= a.max() * (1.0 - TIE_RTOL))[0])

    U = Vf[:, [0]]
    dof_1 = masked_argmax(U)
    P = basis_vector(size=Nh, index=dof_1)
    interpolation_dofs = [dof_1]
    for idx in range(1, Ns):
        uj = Vf[:, [idx]]
        coeff = np.linalg.solve(P.T @ U, P.T @ uj)
        dof_idx = masked_argmax(uj - U @ coeff)
        P = np.hstack((P, basis_vector(size=Nh, index=dof_idx)))
        U = np.hstack((U, uj))
        interpolation_dofs.append(dof_idx)
    return interpolation_dofs, P


class DiscreteEmpiricalInterpolation(Reductor):
    """Vector DEIM: entries are (dof,) tuples."""

    TYPE = EmpiricalInterpolation.DEIM
    ENTRY_WIDTH = 1

    def __init__(self, assemble, grid=None, tree_walk_params=None, name=None,
                 dofs=None, PT_U=None, basis_rom=None):
        """``assemble`` is a bound ``assemble_*(mu, t, entries=...)``
        method of the owning solver. The reference's arguments ``grid``
        (μ name → distribution) and ``tree_walk_params`` (the
        ``RomParameters`` keys) configure training; ``dofs`` (tuples or a
        (k, ENTRY_WIDTH) integer array), ``PT_U`` (k, k) and
        ``basis_rom`` (n_out, k), float64 numpy, make a serving reductor
        of a trained one's parts."""
        super().__init__(grid=grid)
        self.name = name
        self.assemble = assemble
        self.tree_walk_params = tree_walk_params
        # Weighted hierarchical POD (RomParameters.WEIGHTED_POD): the
        # σ-weighted per-branch bases combine without re-normalization.
        self.weighted = bool(
            (tree_walk_params or {}).get(RomParameters.WEIGHTED_POD, False))

        self.N_V = None
        self.PT_U = PT_U
        self.PT_U_inv = None
        self.sigmas = None
        self.dofs = None if dofs is None else self._as_entries(dofs)
        self.basis_fom = None
        self.basis_rom = basis_rom
        self._combine_cache = {}

    @property
    def basis_pickle_name(self):
        """``basis_fom_<type>_<name>.pkl`` (reference ``deim.py:151``)."""
        name = "_".join(str(self.name).lower().split())
        return f"basis_fom_{self.TYPE.lower()}_{name}.pkl"

    def __str__(self) -> str:
        return f"{self.TYPE} - {self.name}"

    def __repr__(self) -> str:
        return self.__str__()

    def _as_entries(self, dofs):
        arr = np.asarray(dofs, dtype=np.int64).reshape(-1, self.ENTRY_WIDTH)
        if arr.shape[0] == 0:
            raise ValueError(f"{self.TYPE} {self.name}: no interpolation "
                             "dofs (serving needs a trained reductor)")
        return [tuple(int(v) for v in row) for row in arr]

    def dofs_array(self):
        """(k, ENTRY_WIDTH) int64 array, the persisted form."""
        return np.asarray(self.dofs, dtype=np.int64).reshape(
            -1, self.ENTRY_WIDTH)

    # ------------------------------------------------------------------
    # The owning solver
    # ------------------------------------------------------------------
    @property
    def solver(self):
        return self.assemble.__self__

    @property
    def Nh(self):
        """Rows of the collateral basis (reference ``deim.py:153-155``)."""
        return self.basis_fom.shape[0]

    @property
    def N(self):
        return self.basis_fom.shape[1]

    def _device(self):
        """Where the assembly runs: the solver's device (raises where it
        is the card and there is none)."""
        return self.solver._compute_device()

    def _mu_tensors(self, mu):
        """μ as 0-d tensors in the compute dtype on the solver's device."""
        return {k: torch.tensor(float(v), dtype=compute_dtype(),
                                device=self._device())
                for k, v in mu.items()}

    def _times(self, ts):
        """Times as a tensor in the compute dtype on the solver's device:
        a scalar stays 0-d, a grid becomes (T,)."""
        return torch.as_tensor(np.asarray(ts, dtype=np.float64),
                               dtype=compute_dtype(), device=self._device())

    def copy(self):
        """A copy carrying the trained data over (reference
        ``deim.py:110-131``)."""
        new = self.__class__(assemble=self.assemble, grid=self.grid,
                             tree_walk_params=self.tree_walk_params,
                             name=self.name)
        for attr in ("basis_fom", "basis_rom", "PT_U", "PT_U_inv", "dofs",
                     "errors_rom", "N_V"):
            value = getattr(self, attr)
            if value is not None:
                setattr(new, attr, deepcopy(value))
        return new

    # ------------------------------------------------------------------
    # Persistence
    # ------------------------------------------------------------------
    def dump_fom_basis(self, path=None):
        """Pickle the collateral basis, a numpy array (reference
        ``deim.py:166-173``)."""
        if self.basis_fom is None:
            raise RuntimeError(
                f"Trying to dump basis for {self.name} without building it!")
        dump_pickle(path or self.basis_pickle_name,
                    obj=np.asarray(self.basis_fom))

    def load_fom_basis(self, keep=None, basis=None):
        """Load a collateral basis (the pickle of
        :attr:`basis_pickle_name` without ``basis``), keep its first
        ``keep`` columns, and rebuild the interpolation mesh (reference
        ``deim.py:133-164``)."""
        if basis is None:
            basis = read_pickle(self.basis_pickle_name)
        basis = np.asarray(basis)
        if keep:
            basis = basis[:, :keep]
        self.basis_fom = basis
        self._finalize_basis()

    # ------------------------------------------------------------------
    # Offline phase
    # ------------------------------------------------------------------
    def _walk_params(self):
        params = self.tree_walk_params
        return dict(ts=params[RomParameters.TS],
                    num_snapshots=params.get(RomParameters.NUM_SNAPSHOTS),
                    num_mu=params.get(RomParameters.NUM_MU),
                    num_t=params.get(RomParameters.NUM_TIME),
                    tol_mu=params.get(RomParameters.TOL_MU),
                    tol_t=params.get(RomParameters.TOL_TIME))

    @offline
    def run(self, normalize=True, mu_space=None):
        """Tree walk + greedy point selection (reference
        ``deim.py:175-215``)."""
        Vfh, sigmas = self.tree_walk(normalize=normalize, mu_space=mu_space,
                                     **self._walk_params())
        self.basis_fom = Vfh
        self.sigmas = sigmas
        self._finalize_basis()

    def _finalize_basis(self):
        """Dofs, PᵀU and its inverse (None where PᵀU is singular) of the
        collateral basis (reference ``deim.py:217-233``)."""
        dofs, P = self.build_interpolation_mesh()
        self.store_dofs(dofs)
        self.PT_U = np.matmul(P.T, self.basis_fom)
        try:
            self.PT_U_inv = np.linalg.inv(self.PT_U)
        except np.linalg.LinAlgError:
            self.PT_U_inv = None
        self._combine_cache = {}

    def build_interpolation_mesh(self):
        return greedy_interpolation_points(
            self.basis_fom, forbidden=self._forbidden_greedy_positions())

    def _forbidden_greedy_positions(self):
        """Dirichlet dof positions: their local assembly is the override
        value, never μ-dependent information."""
        return [int(d) for d in self.solver.dirichlet_dofs]

    def store_dofs(self, dofs):
        """Vector entries (reference ``deim.py:217-224``)."""
        self.dofs = [(int(dof),) for dof in dofs]

    def tree_walk(self, ts, normalize=True, num_mu=None, num_t=None,
                  tol_mu=None, tol_t=None, num_snapshots=None,
                  mu_space=None):
        """POD in time per μ, then POD across μ (reference
        ``deim.py:279-355``)."""
        if mu_space:
            space = mu_space
        elif num_snapshots:
            space = self.build_sampling_space(num=num_snapshots,
                                              rnd=self.random_state)
        else:
            raise ValueError(
                "DEIM tree walk needs either an explicit mu_space or "
                "num_snapshots in tree_walk_params.")

        offline = self.report[Stage.OFFLINE]
        basis_time = []
        for mu in space:
            mu_idx, mu = self.add_mu(step=Stage.OFFLINE, mu=mu)
            _basis, sigmas_time, energy_time = self.walk_time(
                mu=mu, ts=ts, num=num_t, tol=tol_t, normalize=normalize)
            offline[self.SPECTRUM_TIME][mu_idx] = sigmas_time
            offline[self.ENERGY_TIME][mu_idx] = energy_time
            offline[self.BASIS_TIME][mu_idx] = _basis.shape[1]
            basis_time.append(_basis)

        basis = np.hstack(basis_time)
        offline[self.BASIS_AFTER_WALK] = basis.shape[1]
        basis, sigmas_mu, energy_mu = orth(
            snapshots=basis, num=num_mu, tol=tol_mu,
            normalize=normalize and not self.weighted)
        offline[self.SPECTRUM_MU] = sigmas_mu
        offline[self.ENERGY_MU] = energy_mu
        offline[self.BASIS_FINAL] = basis.shape[1]
        return basis, sigmas_mu

    def walk_time(self, mu, ts, normalize=True, num=None, tol=None):
        """The time branch: the snapshots of ``mu`` over ``ts`` in one
        assembly, then their POD, the modes scaled by their σ
        (hierarchical weighting; reference ``deim.py:357-397``)."""
        snapshots = self._mask_boundary_snapshots(
            self.assemble_snapshots_batch(mu, ts))
        basis, sigmas, energy = orth(snapshots=snapshots, num=num, tol=tol,
                                     normalize=False)
        return basis * sigmas[: basis.shape[1]], sigmas, energy

    def _mask_boundary_snapshots(self, snapshots):
        """Hook: MDEIM zeroes the Dirichlet diagonals (reference
        ``deim.py:387-389``)."""
        return snapshots

    # ------------------------------------------------------------------
    # Snapshot assembly
    # ------------------------------------------------------------------
    def _assemble_snapshot_traced(self, mu, t):
        """The snapshot in vector form, (dim, *t.shape): the assembled
        functional itself."""
        return self.assemble(mu=mu, t=t)

    def assemble_snapshot(self, mu, t):
        """One snapshot as numpy (reference ``deim.py:399-414``)."""
        return self._assemble_snapshot_traced(
            self._mu_tensors(mu), self._times(t)).cpu().numpy()

    def assemble_snapshots_batch(self, mu, ts):
        """All time snapshots of one μ as numpy (dim, nt): one assembly
        call on the solver's device, the times its trailing batch axis
        (the reference's vmap over t)."""
        return self._assemble_snapshot_traced(
            self._mu_tensors(mu), self._times(ts)).cpu().numpy()

    # ------------------------------------------------------------------
    # Online interpolation
    # ------------------------------------------------------------------
    def _entries_traced(self, mu, t):
        """Gathered local assembly at the interpolation dofs:
        (k, *batch) for μ/t tensors of batch shape ``batch``."""
        return self.assemble(mu=mu, t=t, entries=self.dofs)

    def compute_thetas(self, rhs):
        """θ from PᵀU θ = f|dofs, float64 numpy (reference
        ``deim.py:379-381``)."""
        return np.linalg.solve(self.PT_U, rhs)

    def _folded_serving(self):
        """The reference's predicate (``deim.py:379``): float32 serving
        pairs the raw entries with the folded combine; float64 solves
        PᵀU θ = entries and combines with the collateral basis. Every θ
        and combine method below keys off it."""
        return compute_dtype() == torch.float32

    def _basis(self, which):
        return self.basis_fom if which == self.FOM else self.basis_rom

    def _combine_matrix(self, which=None):
        """V·(PᵀU)⁻¹ of the FOM (``which`` None or "fom") or the reduced
        collateral basis in float64, cached (reference ``deim.py:389``)."""
        key = self.FOM if which in (None, self.FOM) else self.ROM
        M = self._combine_cache.get(key)
        if M is None:
            inv = (self.PT_U_inv if self.PT_U_inv is not None
                   else np.linalg.inv(np.asarray(self.PT_U, np.float64)))
            M = self._combine_cache[key] = (
                np.asarray(self._basis(key), np.float64)
                @ np.asarray(inv, np.float64))
        return M

    def _serving_combine(self, which=Reductor.ROM):
        """The (n_out, k) matrix that pairs with :meth:`_thetas_traced`
        (float64 numpy): under float32 serving the folded combine, else
        the collateral basis (``basis_fom`` for the FOM, ``basis_rom``
        for the ROM)."""
        key = self.FOM if which in (None, self.FOM) else self.ROM
        if self._basis(key) is None or self.PT_U is None:
            attr = "basis_fom" if key == self.FOM else "basis_rom"
            raise ValueError(
                f"{self.TYPE} {self.name}: the {key} combine needs the "
                f"reductor's PᵀU and {attr} (payload keys "
                f"'PT_U_{self.name}' and 'basis_rom_{self.name}')")
        if not self._folded_serving():
            return self._basis(key)
        return self._combine_matrix(key)

    def _thetas_traced(self, mu, t):
        """θ(μ, t): the gathered entries, then the PᵀU solve unless the
        folded float32 form is active (reference ``deim.py:428-437``).
        (k, *batch)."""
        return self._solve_thetas(self._entries_traced(mu, t))

    def _solve_thetas(self, fh_local):
        """PᵀU θ = f|dofs on (k, …) entries by :func:`solve_small` (the
        trailing axes flattened into lanes); the entries themselves under
        float32 serving."""
        if self._folded_serving():
            return fh_local
        if self.PT_U is None:
            raise ValueError(
                f"{self.TYPE} {self.name}: float64 serving on the global "
                f"basis needs PᵀU (payload key 'PT_U_{self.name}')")
        PT_U = torch.tensor(self.PT_U, dtype=fh_local.dtype,
                            device=fh_local.device)
        k = fh_local.shape[0]
        lanes = fh_local.reshape(k, -1) if fh_local.ndim > 1 else fh_local
        return solve_small(PT_U, lanes).reshape(fh_local.shape)

    def _combine_traced(self, thetas, which=Reductor.ROM):
        """Σθᵢ·Vᵢ: :meth:`_serving_combine` @ θ ((k, …) → (n_out, …)),
        with the Dirichlet repair on the FOM basis."""
        C = torch.tensor(self._serving_combine(which), dtype=thetas.dtype,
                         device=thetas.device)
        approximation = (C @ thetas if thetas.ndim <= 2
                         else torch.tensordot(C, thetas, dims=([1], [0])))
        if which in (None, self.FOM):
            approximation = self._fix_boundary(approximation)
        return approximation

    def _interpolate_traced(self, mu, t, which=None):
        return self._combine_traced(self._thetas_traced(mu, t), which)

    def _fix_boundary(self, approximation):
        """Hook: MDEIM restores the Dirichlet diagonals after a FOM
        interpolation (reference ``deim.py:447-451``)."""
        return approximation

    def _interpolate(self, mu, t, which=None):
        """The interpolated operator in vector form, numpy (reference
        ``deim.py:416-452``)."""
        return self._interpolate_traced(
            self._mu_tensors(mu), self._times(t), which).cpu().numpy()

    def interpolate(self, mu, t, which=None):
        return self._interpolate(mu=mu, t=t, which=which)

    def interpolate_batch(self, mu, ts, which=None):
        """Interpolation over a time grid in one call: (n_out, nt)."""
        return self._interpolate(mu=mu, t=np.asarray(ts), which=which)

    # ------------------------------------------------------------------
    # Projection onto the solution reduced basis
    # ------------------------------------------------------------------
    def project_basis(self, V):
        """VfN = Vᵀ Vfh (reference ``deim.py:495-515``)."""
        V = np.asarray(V)
        self.basis_rom = np.matmul(V.T, self.basis_fom)
        self.N_V = V.shape[1]
        self._combine_cache = {}

    # ------------------------------------------------------------------
    # Online evaluation
    # ------------------------------------------------------------------
    @offline
    def evaluate(self, ts, num=None, mu_space=None):
        """RMS interpolation errors over a μ sample, one (μ, time grid)
        call per μ; each μ's series in ``errors_rom`` (reference
        ``deim.py:226-261``)."""
        if mu_space:
            space = mu_space
        else:
            assert num, "Provide number of samples to test"
            space = self.build_sampling_space(num=num)
        registered = [self.add_mu(step=Stage.ONLINE, mu=mu) for mu in space]
        if not registered:
            return
        names = sorted(registered[0][1].keys())
        batch = {k: np.array([float(m[k]) for _i, m in registered])
                 for k in names}
        errors = self._evaluate_errors_batch(batch, ts)
        for (mu_idx, _mu), err in zip(registered, errors):
            self.errors_rom[mu_idx] = np.array(err)

    def _evaluate_errors_batch(self, mu_batch, ts):
        """(n_mu, nt) RMS interpolation errors against the (masked)
        assembly, μ by μ, each over the whole time grid at once."""
        t = self._times(ts)
        n_mu = len(next(iter(mu_batch.values())))
        rows = []
        for i in range(n_mu):
            mu = self._mu_tensors({k: v[i] for k, v in mu_batch.items()})
            truth = self._mask_evaluation_truth(
                self._assemble_snapshot_traced(mu, t))
            d = truth - self._interpolate_traced(mu, t, which=self.FOM)
            rows.append((torch.linalg.vector_norm(d, dim=0)
                         / np.sqrt(d.shape[0])).cpu().numpy())
        return np.stack(rows)

    def _mask_evaluation_truth(self, truth):
        """Hook: MDEIM compares against the Dirichlet-consistent
        operator."""
        return truth
