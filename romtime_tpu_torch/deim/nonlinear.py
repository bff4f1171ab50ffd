"""Nonlinear MDEIM: empirical interpolation of the state-dependent
trilinear operator N(u) (counterpart of ``romtime_tpu/deim/nonlinear.py``).

The snapshots sweep (μ, t, ψ), ψ the columns of an external state basis;
one assembly per time carries every ψ as its trailing batch axis (the
reference vmaps over t and ψ). :meth:`truncate` makes the sacrificial
"S-" variant sharing the topology. The piston pipeline adopts the
FOM-captured nonlinear basis instead of training
(``rom/hrom.py`` ``_run_mdeim_nonlinear``); windowed and global serving
apply the operator through their exact trilinear tables, and a serving
reductor only assembles N(u) at its entries for a given state.
"""

from copy import deepcopy

import numpy as np
import torch

from ..conventions import EmpiricalInterpolation, Stage, Treewalk
from ..rom.base import Reductor
from ..rom.pod import orth
from .deim import offline
from .mdeim import MatrixDiscreteEmpiricalInterpolation


class MatrixDiscreteEmpiricalInterpolationNonlinear(
        MatrixDiscreteEmpiricalInterpolation):

    TYPE = EmpiricalInterpolation.NONLINEAR

    def __init__(self, assemble, name=None, grid=None, tree_walk_params=None,
                 dofs=None, PT_U=None, basis_rom=None):
        super().__init__(assemble, name=name, grid=grid,
                         tree_walk_params=tree_walk_params, dofs=dofs,
                         PT_U=PT_U, basis_rom=basis_rom)
        # External function basis ψ (reference nonlinear.py:46-47)
        self.u_n = None

    def copy(self):
        new = super().copy()
        if self.u_n is not None:
            new.u_n = self.u_n
        return new

    def truncate(self, n):
        """Remove ``n`` modes, rebuilding the interpolation mesh; the
        topology is shared (reference ``nonlinear.py:49-104``)."""
        truncated = self.__class__(assemble=self.assemble, grid=self.grid,
                                   tree_walk_params=self.tree_walk_params,
                                   name="S-" + self.name)
        Reductor.setup(self=truncated, rnd=self.random_state)
        truncated.rows = self.rows
        truncated.cols = self.cols
        truncated._boundary_positions = self._boundary_positions
        N = self.N
        assert n < N, (
            "You want to remove too many modes from S-NonlinearMDEIM "
            "to create NonlinearMDEIM.")
        truncated.basis_fom = self.basis_fom[:, : N - n]
        truncated.u_n = self.u_n
        truncated._finalize_basis()
        truncated.mu_space = deepcopy(self.mu_space)
        truncated.report = deepcopy(self.report)
        truncated.report[Stage.OFFLINE][Treewalk.BASIS_FINAL] = truncated.N
        return truncated

    # ------------------------------------------------------------------
    # Topology: probed with a non-constant state
    # ------------------------------------------------------------------
    @offline
    def setup(self, rnd, V=None):
        """Probe the topology with u = x so every structural entry is
        live (reference ``nonlinear.py:133-157``)."""
        Reductor.setup(self=self, rnd=rnd)
        mu = list(self.build_sampling_space(num=1))[0]
        u_n = np.asarray(self.solver.mesh.x_dofs)
        self.rows, self.cols = self.get_matrix_topology(mu=mu, t=1.0,
                                                        u_n=u_n)
        self._compute_boundary_positions()

    def _state(self, u_n):
        """A state as a tensor on the solver's device in the compute
        dtype (a factorized (V, coeff) state passes as it is)."""
        if u_n is None or isinstance(u_n, tuple):
            return u_n
        return self._times(u_n)

    def get_matrix_topology(self, mu, t, u_n=None):
        op = self.assemble(mu=self._mu_tensors(mu), t=self._times(t),
                           u_n=self._state(u_n))
        rows, cols, _ = op.nonzero_entries(tolerance=1e-15)
        return rows, cols

    # ------------------------------------------------------------------
    # Offline phase
    # ------------------------------------------------------------------
    @offline
    def run(self, u_n, mu_space=None):
        """The N-MDEIM offline phase over the ψ basis ``u_n`` (reference
        ``nonlinear.py:159-212``)."""
        u_n = np.asarray(u_n)
        if u_n.ndim == 1:
            u_n = u_n.reshape((-1, 1))
        self.u_n = u_n
        Vfh, sigmas = self.tree_walk(normalize=True, mu_space=mu_space,
                                     **self._walk_params())
        self.basis_fom = Vfh
        self.sigmas = sigmas
        self._finalize_basis()

    # ------------------------------------------------------------------
    # Snapshots over (t, ψ)
    # ------------------------------------------------------------------
    def _assemble_snapshot_traced(self, mu, t, u_n=None):
        op = self.assemble(mu=mu, t=t, u_n=u_n)
        return op.gather(self.rows, self.cols)

    def assemble_snapshot(self, mu, t, u_n=None):
        return self._assemble_snapshot_traced(
            self._mu_tensors(mu), self._times(t),
            self._state(u_n)).cpu().numpy()

    def assemble_snapshots_batch_psi(self, mu, ts):
        """All (t, ψ) snapshots of one μ, numpy (nt, k, nnz): one
        assembly per time, the k columns of ``u_n`` its trailing batch."""
        mu_t = self._mu_tensors(mu)
        psi = self._state(self.u_n)
        return np.stack([
            self._assemble_snapshot_traced(mu_t, self._times(t), psi)
            .T.cpu().numpy() for t in np.asarray(ts)])

    def walk_time(self, mu, ts, normalize=True, num=None, tol=None):
        """Per-t POD over the ψ branch, then POD over time, σ-weighted
        (reference ``nonlinear.py:405-468``)."""
        basis_time = []
        for snap_t in self.assemble_snapshots_batch_psi(mu, ts):
            snapshots = self._mask_boundary_snapshots(snap_t.T)  # (nnz, k)
            phi_psi, s_psi, _ = orth(snapshots=snapshots, num=num, tol=tol,
                                     normalize=normalize)
            basis_time.append(phi_psi * s_psi[: phi_psi.shape[1]])
        phi, sigmas, energy = orth(
            snapshots=np.hstack(basis_time), num=num, tol=tol,
            normalize=normalize and not self.weighted)
        return phi * sigmas[: phi.shape[1]], sigmas, energy

    # ------------------------------------------------------------------
    # Online interpolation (state-dependent)
    # ------------------------------------------------------------------
    def _entries_traced(self, mu, t, u_n=None):
        return self.assemble(mu=mu, t=t, entries=self.dofs, u_n=u_n)

    def _interpolate_traced(self, mu, t, u_n=None, which=None):
        thetas = self._solve_thetas(self._entries_traced(mu, t, u_n))
        return self._combine_traced(thetas, which)

    def _interpolate(self, mu, t, u_n=None, which=None):
        return self._interpolate_traced(
            self._mu_tensors(mu), self._times(t), self._state(u_n),
            which).cpu().numpy()

    def interpolate(self, mu, t, u_n=None, which=None):
        """The FOM operator as a banded operator, the ROM one as a dense
        (N_V, N_V) array (reference ``nonlinear.py:214-245``)."""
        approximation = self._interpolate(mu, t, u_n=u_n, which=which)
        if which == self.ROM:
            return approximation.reshape((self.N_V, self.N_V))
        return self.to_operator(approximation)

    # ------------------------------------------------------------------
    # Online evaluation
    # ------------------------------------------------------------------
    @offline
    def evaluate(self, ts, funcs=None, num=None, mu_space=None):
        """Interpolation error averaged over the ψ columns, per μ and t
        (reference ``nonlinear.py:470-540``)."""
        if mu_space:
            space = mu_space
        else:
            assert num, "Provide number of samples to test"
            space = self.build_sampling_space(num=num)
        psi = self._state(self.u_n if funcs is None else np.asarray(funcs))
        for mu in space:
            mu_idx, mu = self.add_mu(step=Stage.ONLINE, mu=mu)
            mu_t = self._mu_tensors(mu)
            errors = []
            for t in np.asarray(ts):
                t_t = self._times(t)
                diff = (self._assemble_snapshot_traced(mu_t, t_t, psi)
                        - self._interpolate_traced(mu_t, t_t, psi,
                                                   which=self.FOM))
                errors.append(float(torch.mean(
                    torch.linalg.vector_norm(diff, dim=0)
                    / np.sqrt(diff.shape[0]))))
            self.errors_rom[mu_idx] = np.array(errors)
