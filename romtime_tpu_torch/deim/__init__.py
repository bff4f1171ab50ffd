from .deim import DiscreteEmpiricalInterpolation
from .mdeim import MatrixDiscreteEmpiricalInterpolation
from .nonlinear import MatrixDiscreteEmpiricalInterpolationNonlinear

__all__ = [
    "DiscreteEmpiricalInterpolation",
    "MatrixDiscreteEmpiricalInterpolation",
    "MatrixDiscreteEmpiricalInterpolationNonlinear",
]
