"""Model registry (counterpart of ``romtime_tpu/models/__init__.py``):
the solver families the port ships, by name. The physics lives in
:mod:`romtime_tpu_torch.fom`; this module is the flat index."""

from ..fom.base import OneDimensionalSolver
from ..fom.heat import HeatEquationMovingSolver, HeatEquationSolver
from ..fom.nonlinear import OneDimensionalBurgers

MODEL_REGISTRY = {
    "heat": HeatEquationSolver,
    "heat-moving": HeatEquationMovingSolver,
    "piston": OneDimensionalBurgers,
    "burgers": OneDimensionalBurgers,
}


def get_model(name):
    """The solver class registered under ``name``; ``KeyError`` naming
    the registered models otherwise."""
    try:
        return MODEL_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"Unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}"
        ) from None


__all__ = [
    "MODEL_REGISTRY",
    "get_model",
    "OneDimensionalSolver",
    "HeatEquationSolver",
    "HeatEquationMovingSolver",
    "OneDimensionalBurgers",
]
