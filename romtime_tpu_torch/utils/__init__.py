from .io import (
    dump_csv,
    dump_json,
    dump_npz,
    dump_pickle,
    read_json,
    read_npz,
    read_pickle,
)
from .numeric import compute_rom_difference, time_average

__all__ = [
    "compute_rom_difference",
    "time_average",
    "dump_csv",
    "dump_json",
    "dump_npz",
    "dump_pickle",
    "read_json",
    "read_npz",
    "read_pickle",
]
