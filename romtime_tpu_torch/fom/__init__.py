from .base import BandedOperator, OneDimensionalSolver, move_mesh
from .nonlinear import OneDimensionalBurgers

__all__ = ["BandedOperator", "OneDimensionalSolver", "OneDimensionalBurgers",
           "move_mesh"]
