from .registration import DilationLaw
from .rom import RomConstructorNonlinear
from .windowed import WindowedServing

__all__ = ["DilationLaw", "RomConstructorNonlinear", "WindowedServing"]
