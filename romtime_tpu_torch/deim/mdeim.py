"""Matrix DEIM reductor, serving subset (counterpart of
``romtime_tpu/deim/mdeim.py``): entries are (row, col) pairs of the
operator. The Dirichlet hook on interpolation entries (identity diagonal,
zero off-diagonals on pinned rows) is applied by the solver's entry map
(``ops/mesh.py`` ``build_entry_map``), as in the reference's gathered
assembly."""

from .deim import DiscreteEmpiricalInterpolation


class MatrixDiscreteEmpiricalInterpolation(DiscreteEmpiricalInterpolation):

    TYPE = "MDEIM"
    ENTRY_WIDTH = 2
