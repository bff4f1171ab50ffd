from .engines.global_fused import GlobalServing
from .registration import DilationLaw
from .rom import RomConstructorNonlinear
from .windowed import WindowedServing

__all__ = ["DilationLaw", "GlobalServing", "RomConstructorNonlinear",
           "WindowedServing"]
