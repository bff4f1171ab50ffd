"""Multi-device execution (counterpart of ``romtime_tpu/parallel``):
μ-batch sweeps of the FOM and the ROM, one batch on one device or
sharded over a :class:`DeviceMesh` (:mod:`.sweep`), and POD by TSQR over
the mesh (:mod:`.tsqr`). One process drives every device (:mod:`.mesh`);
:mod:`.dryrun` runs the offline step and the routed serving over a mesh
on tiny shapes, and has the scanned forward solve of the tiny piston
(``entry``)."""

from .dryrun import dryrun_multichip, entry
from .mesh import MU_AXIS, DeviceMesh, device_mesh, mu_sharding, replicated
from .sweep import (
    solve_fom_batch,
    solve_fom_sharded,
    solve_online_sharded,
    solve_online_windowed_sharded,
)
from .tsqr import orth_distributed, tsqr_svd

__all__ = [
    "MU_AXIS",
    "DeviceMesh",
    "dryrun_multichip",
    "entry",
    "device_mesh",
    "mu_sharding",
    "replicated",
    "tsqr_svd",
    "orth_distributed",
    "solve_fom_batch",
    "solve_fom_sharded",
    "solve_online_sharded",
    "solve_online_windowed_sharded",
]
