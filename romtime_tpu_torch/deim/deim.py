"""DEIM reductor, serving subset (counterpart of
``romtime_tpu/deim/deim.py``).

Serving needs the interpolation dofs and the gathered assembly at them
(``_entries_traced``, reference ``deim.py:422``), which the windowed
engines and the global kernels stream against folded combine tensors.
The global lanes engine pairs θ(μ, t) with a combine matrix as the
reference does (``deim.py:379-452``): under float32 serving the raw
entries with the folded V·(PᵀU)⁻¹ (the global configuration's
``combine_<source>``); in float64 the PᵀU solve (``PT_U``) with the
reduced collateral basis (``basis_rom``). Training (tree walk, greedy
selection) and the FOM-basis combine with its Dirichlet repair
(``_fix_boundary``, reference ``mdeim.py:135``) stay in the JAX package;
a reductor here is built from what they produced.
"""

import numpy as np
import torch

from ..conventions import ProblemType
from ..dtypes import compute_dtype
from ..ops.linalg import solve_small


class DiscreteEmpiricalInterpolation:
    """Vector DEIM: entries are (dof,) tuples."""

    TYPE = "DEIM"
    ENTRY_WIDTH = 1
    ROM = ProblemType.ROM

    def __init__(self, assemble, dofs, name=None, PT_U=None, basis_rom=None):
        """``assemble`` is a bound ``assemble_*(mu, t, entries=...)``
        method of the owning solver; ``dofs`` the interpolation entries,
        as tuples or a (k, ENTRY_WIDTH) integer array. The optional
        reduced parts, float64 numpy: ``PT_U`` (k, k) and ``basis_rom``
        (n_out, k)."""
        self.assemble = assemble
        self.name = name
        self.dofs = self._as_entries(dofs)
        self.PT_U = PT_U
        self.basis_rom = basis_rom
        self._folded = None

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

    def _entries_traced(self, mu, t):
        """Gathered local assembly at the interpolation dofs:
        (k, *batch) for μ/t tensors of batch shape ``batch``."""
        return self.assemble(mu=mu, t=t, entries=self.dofs)

    def _folded_serving(self):
        """The reference's predicate (``deim.py:379``): float32 serving
        pairs the raw entries with the folded combine; float64 solves
        PᵀU θ = entries and combines with ``basis_rom``. Every θ and
        combine method below keys off it."""
        return compute_dtype() == torch.float32

    def _serving_combine(self, which=ProblemType.ROM):
        """The (n_out, k) matrix that pairs with :meth:`_thetas_traced`
        (float64 numpy): under float32 serving the folded
        basis_rom·(PᵀU)⁻¹ (the reference's ``_combine_matrix``, computed
        once), else ``basis_rom``. Only the reduced basis is served."""
        if which != self.ROM:
            raise NotImplementedError(
                f"{self.TYPE} {self.name}: the FOM-basis combine is offline "
                "work that stays in the JAX package")
        if self.basis_rom is None or self.PT_U is None:
            raise ValueError(
                f"{self.TYPE} {self.name}: the reduced combine needs the "
                f"reductor's PᵀU and basis_rom (payload keys "
                f"'PT_U_{self.name}' and 'basis_rom_{self.name}')")
        if not self._folded_serving():
            return self.basis_rom
        if self._folded is None:
            self._folded = (np.asarray(self.basis_rom, np.float64)
                            @ np.linalg.inv(np.asarray(self.PT_U, np.float64)))
        return self._folded

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

    def _combine_traced(self, thetas, which=ProblemType.ROM):
        """Σθᵢ·Vᵢ in the reduced basis: :meth:`_serving_combine` @ θ
        ((k, …) → (n_out, …)). ``_fix_boundary`` acts only on the FOM
        basis, which is not served, so it is left out."""
        C = torch.tensor(self._serving_combine(which), dtype=thetas.dtype,
                         device=thetas.device)
        return C @ thetas
