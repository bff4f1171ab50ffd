from .engines.global_fused import GlobalServing
from .hrom import HyperReducedPiston
from .registration import DilationLaw
from .rom import RomConstructorNonlinear
from .windowed import MuLocalWindowed, WindowedServing

__all__ = ["DilationLaw", "GlobalServing", "HyperReducedPiston",
           "MuLocalWindowed", "RomConstructorNonlinear", "WindowedServing"]
