"""DEIM reductor, serving subset (counterpart of
``romtime_tpu/deim/deim.py``).

Serving needs only the interpolation dofs and the gathered assembly at
them (``_entries_traced``, reference ``deim.py:422``): the folded combine
tensors of the windowed serving configuration act on those raw entries.
Training (tree walk, greedy selection) stays in the JAX package; a
reductor here is built from the dofs it selected.
"""

import numpy as np


class DiscreteEmpiricalInterpolation:
    """Vector DEIM: entries are (dof,) tuples."""

    TYPE = "DEIM"
    ENTRY_WIDTH = 1

    def __init__(self, assemble, dofs, name=None):
        """``assemble`` is a bound ``assemble_*(mu, t, entries=...)``
        method of the owning solver; ``dofs`` the interpolation entries,
        as tuples or a (k, ENTRY_WIDTH) integer array."""
        self.assemble = assemble
        self.name = name
        self.dofs = self._as_entries(dofs)

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
