"""PyTorch + CUDA port of ``romtime_tpu`` for NVIDIA Hopper (H100).

First slice: windowed piston probe serving. The offline build stays in
the JAX package; serving configurations are carried across as numpy
(``convert.serving_from_arrays``). The serving sweep runs the hand-written
CUDA kernel K1 (``csrc/windowed_fused.cu``) for CUDA tensors and its
plain PyTorch twin for CPU tensors. Importing the package loads torch and
numpy only; the kernel is built at its first launch.
"""

from .convert import serving_from_arrays, serving_to_arrays
from .rom import DilationLaw, RomConstructorNonlinear, WindowedServing

__all__ = [
    "DilationLaw",
    "RomConstructorNonlinear",
    "WindowedServing",
    "serving_from_arrays",
    "serving_to_arrays",
]
