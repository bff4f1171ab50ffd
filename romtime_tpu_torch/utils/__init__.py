from .io import (
    dump_csv,
    dump_json,
    dump_npz,
    dump_pickle,
    read_json,
    read_npz,
    read_pickle,
)
from .numeric import (
    compute_rom_difference,
    eliminate_zeros_vector,
    project_dense,
    singular_to_energy,
    singular_to_pod_error,
    time_average,
)
from .profiling import PhaseTimer, block_and_time, torch_trace
from .progress import progress

__all__ = [
    "compute_rom_difference",
    "eliminate_zeros_vector",
    "project_dense",
    "singular_to_energy",
    "singular_to_pod_error",
    "time_average",
    "dump_csv",
    "dump_json",
    "dump_npz",
    "dump_pickle",
    "read_json",
    "read_npz",
    "read_pickle",
    "PhaseTimer",
    "block_and_time",
    "torch_trace",
    "progress",
]
