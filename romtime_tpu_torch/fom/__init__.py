from .base import OneDimensionalSolver
from .nonlinear import OneDimensionalBurgers

__all__ = ["OneDimensionalSolver", "OneDimensionalBurgers"]
