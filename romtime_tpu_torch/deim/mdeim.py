"""Matrix DEIM: empirical interpolation of parametrized operators stored
as vectors of structural nonzeros (counterpart of
``romtime_tpu/deim/mdeim.py``). Entries are (row, col) pairs of the
operator.

The fixed banded layout of the 1-D FEM operators gives the "matrix as
vector" form: the topology (rows, cols) is probed once per operator, a
snapshot is the band gathered on it, a collateral mode is scattered back
into a band to project it (Vᵀ·A·V, float64 numpy on the host). On
interpolation entries the Dirichlet hook (identity diagonal, zero
off-diagonals on pinned rows) is applied by the solver's entry map
(``ops/mesh.py`` ``build_entry_map``), as in the reference's gathered
assembly; on the FOM basis :meth:`_fix_boundary` restores the pinned
diagonals.
"""

from copy import deepcopy

import numpy as np
import torch

from ..conventions import EmpiricalInterpolation
from ..ops.assembly import nnz_to_band
from .deim import DiscreteEmpiricalInterpolation, offline


def project_band(band, V):
    """Vᵀ·A_i·V of each operator of a banded stack ``band``
    (2p+1, nh, k), flattened row-major: (N², k) float64 numpy for V
    (nh, N) (reference ``mdeim.py:24-38``). Computed in float64 on the
    band's device where it is a tensor (a table assembled on the card is
    projected there), on the CPU for an array."""
    band = torch.as_tensor(band).to(torch.float64)
    V = torch.as_tensor(np.asarray(V, np.float64), device=band.device)
    p, nh, N = (band.shape[0] - 1) // 2, band.shape[1], V.shape[1]
    Vpad = torch.nn.functional.pad(V, (0, 0, p, p))
    AV = sum(band[d][:, None, :] * Vpad[d:d + nh][:, :, None]
             for d in range(2 * p + 1))                       # (nh, N, k)
    return (V.T @ AV.reshape(nh, -1)).reshape(N * N, -1).cpu().numpy()


class MatrixDiscreteEmpiricalInterpolation(DiscreteEmpiricalInterpolation):

    TYPE = EmpiricalInterpolation.MDEIM
    ENTRY_WIDTH = 2

    def __init__(self, assemble, name=None, grid=None, tree_walk_params=None,
                 dofs=None, PT_U=None, basis_rom=None):
        super().__init__(assemble=assemble, grid=grid,
                         tree_walk_params=tree_walk_params, name=name,
                         dofs=dofs, PT_U=PT_U, basis_rom=basis_rom)
        # Matrix topology (reference mdeim.py:64-66)
        self.rows = None
        self.cols = None
        self._boundary_positions = None

    def copy(self):
        new = super().copy()
        for attr in ("rows", "cols", "_boundary_positions"):
            value = getattr(self, attr)
            if value is not None:
                setattr(new, attr, deepcopy(value))
        return new

    # ------------------------------------------------------------------
    # Topology
    # ------------------------------------------------------------------
    @offline
    def setup(self, rnd):
        """Fix the operator's nonzero topology from one sampled assembly
        (reference ``mdeim.py:79-100``)."""
        super().setup(rnd=rnd)
        mu = list(self.build_sampling_space(num=1))[0]
        self.rows, self.cols = self.get_matrix_topology(mu=mu, t=1.0)
        self._compute_boundary_positions()

    def get_matrix_topology(self, mu, t):
        """The stored-nonzero pattern, sorted by (row, col), zeros within
        1e-15 dropped (reference ``mdeim.py:126-151``)."""
        op = self.assemble(mu=self._mu_tensors(mu), t=self._times(t))
        rows, cols, _ = op.nonzero_entries(tolerance=1e-15)
        return rows, cols

    def _compute_boundary_positions(self):
        """Positions in the nonzero vector holding a Dirichlet diagonal
        (d, d), d a Dirichlet dof (reference ``mdeim.py:102-115``)."""
        dirichlet = set(int(d) for d in self.solver.dirichlet_dofs)
        mask = np.array([(r == c) and (int(r) in dirichlet)
                         for r, c in zip(self.rows, self.cols)])
        self._boundary_positions = np.where(mask)[0]

    def store_dofs(self, dofs):
        """Vector index → (row, col) (reference ``mdeim.py:117-124``)."""
        self.dofs = [self.get_entry(dof) for dof in dofs]

    def _forbidden_greedy_positions(self):
        return list(self._boundary_positions)

    def get_entry(self, idx):
        return int(self.rows[idx]), int(self.cols[idx])

    # ------------------------------------------------------------------
    # Snapshots: the band gathered on the fixed topology
    # ------------------------------------------------------------------
    def _assemble_snapshot_traced(self, mu, t):
        return self.assemble(mu=mu, t=t).gather(self.rows, self.cols)

    def _mask_boundary_snapshots(self, snapshots):
        """Zero the Dirichlet diagonals before the POD (reference
        ``mdeim.py:158-163``)."""
        snapshots = np.array(snapshots)
        snapshots[self._boundary_positions, :] = 0.0
        return snapshots

    def _fix_boundary(self, approximation):
        """Restore the Dirichlet identity entries on a FOM interpolation
        (reference ``mdeim.py:165-173``)."""
        if self._boundary_positions is None or not len(
                self._boundary_positions):
            return approximation
        approximation = approximation.clone()
        approximation[torch.as_tensor(self._boundary_positions,
                                      device=approximation.device)] = (
            self.solver.DIRICHLET_ENTRY)
        return approximation

    # ------------------------------------------------------------------
    # Projection: per-mode VᵀA_iV on banded storage
    # ------------------------------------------------------------------
    def project_basis(self, V):
        """Project every collateral mode, A_N = Vᵀ·A·V, flattened
        (reference ``mdeim.py:175-192``), in float64 on the solver's
        device (a windowed build projects every window's basis)."""
        mesh = self.solver.mesh
        device = self._device()
        band = torch.zeros((2 * mesh.degree + 1, mesh.nh, self.N),
                           dtype=torch.float64, device=device)
        rows = torch.as_tensor(np.asarray(self.rows), device=device)
        cols = torch.as_tensor(np.asarray(self.cols), device=device)
        band[cols - rows + mesh.degree, rows] = torch.as_tensor(
            np.asarray(self.basis_fom, np.float64), device=device)
        self.basis_rom = project_band(band, V)
        self.N_V = np.asarray(V).shape[1]
        self._combine_cache = {}

    # ------------------------------------------------------------------
    # Online interpolation
    # ------------------------------------------------------------------
    def interpolate(self, mu, t, which=None):
        """The FOM operator as a banded operator, the ROM one as a dense
        (N_V, N_V) array (reference ``mdeim.py:230-261``)."""
        approximation = self._interpolate(mu, t, which=which)
        if which == self.ROM:
            return approximation.reshape((self.N_V, self.N_V))
        return self.to_operator(approximation)

    def to_operator(self, values):
        """Scatter a nonzero vector back into a banded operator."""
        from ..fom.base import BandedOperator

        mesh = self.solver.mesh
        band = nnz_to_band(torch.as_tensor(values), np.asarray(self.rows),
                           np.asarray(self.cols), mesh.degree, mesh.nh)
        return BandedOperator(band, mesh)
