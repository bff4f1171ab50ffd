from .engines.global_fused import GlobalServing
from .hrom import (
    HyperReducedOrderModelFixed,
    HyperReducedOrderModelMoving,
    HyperReducedPiston,
)
from .registration import DilationLaw
from .rom import RomConstructor, RomConstructorMoving, RomConstructorNonlinear
from .windowed import MuLocalWindowed, WindowedServing

__all__ = ["DilationLaw", "GlobalServing", "HyperReducedOrderModelFixed",
           "HyperReducedOrderModelMoving", "HyperReducedPiston",
           "MuLocalWindowed", "RomConstructor", "RomConstructorMoving",
           "RomConstructorNonlinear", "WindowedServing"]
