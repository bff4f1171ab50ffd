from .base import BandedOperator, OneDimensionalSolver, move_mesh
from .heat import HeatEquationMovingSolver, HeatEquationSolver
from .nonlinear import OneDimensionalBurgers

__all__ = ["BandedOperator", "HeatEquationMovingSolver", "HeatEquationSolver",
           "OneDimensionalSolver", "OneDimensionalBurgers", "move_mesh"]
