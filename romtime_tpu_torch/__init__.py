"""PyTorch + CUDA port of ``romtime_tpu`` for NVIDIA Hopper (H100).

Piston probe serving, windowed (``engine="windowed-pallas"``), on the
global basis (``engine="pallas"``) and over a μ-local fleet of windowed
Mach cells (``solve_batch_mulocal``), with the global and windowed lanes
engines (``engine="lanes"``, ``engine="windowed"``) in every mode and the
S-ROM estimator (``HyperReducedPiston.estimate_batch``,
``estimate_batch_mulocal``) for certification. The piston full-order
model runs on the card too: ``OneDimensionalBurgers.setup()``/``solve()``
and the batched sweep ``parallel.solve_fom_batch`` (the BDF-2 loop and
its compensated dd form, banded assembly and cyclic-reduction solves in
eager torch; ``convert.piston_fom``, ``convert.fom_from_arrays``). The
port builds its own global ROM: ``HyperReducedPiston(grid, fom_params,
...)``'s offline phases (POD, DEIM/MDEIM/N-MDEIM training, the
reduced-basis build, the trilinear table, the dumps and the resume),
whose ROM and S-ROM serve and certify as they are. The windowed and
μ-local builds stay in the JAX package; their serving configurations
are carried across as numpy (``convert.serving_from_arrays``,
``convert.global_serving_from_arrays``,
``convert.fleet_serving_from_arrays``, ``convert.estimator_from_arrays``).
The serving sweeps run the hand-written CUDA kernels K1-K5
(``csrc/*.cu``) for CUDA tensors and their plain PyTorch twins for CPU
tensors. Importing the package loads torch and numpy only; a kernel is
built at its first launch.
"""

from .convert import (
    estimator_from_arrays,
    estimator_to_arrays,
    fleet_serving_from_arrays,
    fleet_serving_to_arrays,
    global_serving_from_arrays,
    global_serving_to_arrays,
    serving_from_arrays,
    serving_to_arrays,
)
from .rom import (
    DilationLaw,
    GlobalServing,
    HyperReducedPiston,
    MuLocalWindowed,
    RomConstructorNonlinear,
    WindowedServing,
)

__all__ = [
    "DilationLaw",
    "GlobalServing",
    "HyperReducedPiston",
    "MuLocalWindowed",
    "RomConstructorNonlinear",
    "WindowedServing",
    "estimator_from_arrays",
    "estimator_to_arrays",
    "fleet_serving_from_arrays",
    "fleet_serving_to_arrays",
    "global_serving_from_arrays",
    "global_serving_to_arrays",
    "serving_from_arrays",
    "serving_to_arrays",
]
