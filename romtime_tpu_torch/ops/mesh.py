"""Static 1-D interval-mesh topology and DEIM entry maps (counterpart of
``romtime_tpu/ops/mesh.py``). Dofs are ordered left→right, so cell ``e``
of degree ``p`` owns dofs ``e*p .. e*p+p`` and every operator is banded
with half-bandwidth ``p``. The structures are numpy, computed once; the
assembly reads them as tensors cached per (dtype, device)
(:meth:`Mesh1D.on`)."""

from dataclasses import dataclass
from functools import cached_property
from types import SimpleNamespace

import numpy as np
import torch

from .element import lagrange_tables


@dataclass(frozen=True)
class EntryMap:
    """Static gather map: DEIM entries → element-local contributions.

    ``elements`` are the unique cells to integrate; each contribution
    ``t`` adds local value (term_elem_pos[t], term_i[t], term_j[t]) into
    entry ``term_entry[t]``. Entries on Dirichlet rows are overridden by
    ``dirichlet_values`` where ``dirichlet_mask`` is set."""

    entries: tuple
    elements: np.ndarray
    term_elem_pos: np.ndarray
    term_i: np.ndarray
    term_j: np.ndarray
    term_entry: np.ndarray
    dirichlet_mask: np.ndarray
    dirichlet_values: np.ndarray
    is_vector: bool

    @property
    def n_entries(self):
        return len(self.entries)


@dataclass(frozen=True)
class Mesh1D:
    """Uniform interval mesh [0, L0] with nx cells of degree ``degree``."""

    L0: float
    nx: int
    degree: int = 1

    @property
    def ne(self):
        return self.nx

    @property
    def p(self):
        return self.degree

    @property
    def nh(self):
        return self.nx * self.degree + 1

    @property
    def h0(self):
        return self.L0 / self.nx

    @cached_property
    def tables(self):
        return lagrange_tables(self.degree)

    @cached_property
    def x_dofs(self):
        return np.linspace(0.0, self.L0, self.nh)

    @cached_property
    def xq_ref(self):
        """Reference quadrature coordinates (ne, Q)."""
        starts = self.h0 * np.arange(self.ne)
        return starts[:, None] + self.h0 * self.tables.quad_points[None, :]

    @cached_property
    def scatter_rows(self):
        """scatter_rows[i]: the global rows of local index i, by cell."""
        p = self.degree
        return [i + p * np.arange(self.ne) for i in range(p + 1)]

    @cached_property
    def _tensors(self):
        return {}

    def on(self, dtype, device):
        """The static tables as tensors of ``dtype`` on ``device``, made
        once per (dtype, device) so a time loop copies nothing from the
        host: ``B0``, ``B1``, ``w`` (quadrature weights), ``coeffs``,
        ``xq`` (:attr:`xq_ref`), ``x`` (:attr:`x_dofs`) and ``forms``, the
        weak forms' quadrature tables (``ops.assembly._form_table``)."""
        device = torch.device(device)
        key = (dtype, device)
        got = self._tensors.get(key)
        if got is None:
            t = self.tables

            def conv(a):
                return torch.as_tensor(np.asarray(a), dtype=dtype,
                                       device=device)

            got = SimpleNamespace(B0=conv(t.B0), B1=conv(t.B1),
                                  w=conv(t.quad_weights),
                                  coeffs=conv(t.coeffs), xq=conv(self.xq_ref),
                                  x=conv(self.x_dofs), forms={})
            self._tensors[key] = got
        return got

    def cell_dofs(self, e):
        p = self.degree
        return list(range(e * p, e * p + p + 1))

    def dof_cells(self, dof):
        """Cells whose basis support covers ``dof``."""
        p = self.degree
        if dof % p == 0:
            vertex = dof // p
            return [e for e in (vertex - 1, vertex) if 0 <= e < self.ne]
        return [dof // p]

    @cached_property
    def band_pattern(self):
        """Structural nonzero pattern (rows, cols) of any assembled
        operator, sorted by (row, col): the CSR storage order, which fixes
        the MDEIM vector layout (reference ``mesh.py:135-153``)."""
        pairs = set()
        for e in range(self.ne):
            dofs = self.cell_dofs(e)
            for i in dofs:
                for j in dofs:
                    pairs.add((i, j))
        pairs = sorted(pairs)
        rows = np.array([r for r, _ in pairs], dtype=np.int64)
        cols = np.array([c for _, c in pairs], dtype=np.int64)
        return rows, cols

    def build_entry_map(self, entries, dirichlet_dofs=(), dirichlet_entry=1.0,
                        dirichlet_value=0.0):
        """Gather map for per-entry (DEIM) assembly of ``entries``: (row,
        col) matrix entries or (dof,) vector entries. Dirichlet rows are
        overridden wholesale (identity diagonal, zero off-diagonals, pinned
        vector value)."""
        entries = tuple(tuple(int(v) for v in entry) for entry in entries)
        if not entries:
            raise ValueError("Empty entry list.")
        is_vector = len(entries[0]) == 1
        dirichlet = set(int(d) for d in dirichlet_dofs)
        p = self.degree

        term_e, term_i, term_j, term_entry = [], [], [], []
        diri_mask = np.zeros(len(entries), dtype=bool)
        diri_vals = np.zeros(len(entries), dtype=np.float64)
        for k, entry in enumerate(entries):
            if is_vector:
                (dof,) = entry
                if dof in dirichlet:
                    diri_mask[k] = True
                    diri_vals[k] = dirichlet_value
                    continue
                for e in self.dof_cells(dof):
                    term_e.append(e)
                    term_i.append(dof - e * p)
                    term_j.append(0)
                    term_entry.append(k)
            else:
                row, col = entry
                if row in dirichlet:
                    diri_mask[k] = True
                    diri_vals[k] = dirichlet_entry if row == col else 0.0
                    continue
                cells = set(self.dof_cells(row)) & set(self.dof_cells(col))
                for e in sorted(cells):
                    term_e.append(e)
                    term_i.append(row - e * p)
                    term_j.append(col - e * p)
                    term_entry.append(k)

        term_e = np.asarray(term_e, dtype=np.int64)
        elements, elem_pos = np.unique(term_e, return_inverse=True)
        return EntryMap(
            entries=entries,
            elements=elements,
            term_elem_pos=elem_pos.astype(np.int64),
            term_i=np.asarray(term_i, dtype=np.int64),
            term_j=np.asarray(term_j, dtype=np.int64),
            term_entry=np.asarray(term_entry, dtype=np.int64),
            dirichlet_mask=diri_mask,
            dirichlet_values=diri_vals,
            is_vector=is_vector,
        )
