"""Test-side helpers shared by the port's parity tests (not collected):
carry a JAX-built serving configuration across to the PyTorch port, and
run the reference's fused windowed serving the way
tests/test_windowed.py runs it."""

import contextlib
import io
import os

import jax.numpy as jnp
import numpy as np

from romtime_tpu.conventions import Stage
from romtime_tpu.dtypes import compute_dtype_scope


def payload_from_rom(rom, which="rest"):
    """The port's serving payload (romtime_tpu_torch.convert) from a JAX
    ``RomConstructorNonlinear`` with windowed serving attached."""
    buf = io.BytesIO()
    rom.windows.dump(buf)
    buf.seek(0)
    with np.load(buf) as data:
        payload = {k: data[k] for k in data.files}
    for name, (red, _fb) in rom._theta_sources().items():
        payload[f"dofs_{name}"] = np.asarray(red.dofs, np.int64).reshape(
            len(red.dofs), -1)
    fom = rom.fom
    payload.update(
        fom_L0=np.float64(fom.domain[fom.L0]),
        fom_nx=np.int64(fom.domain[fom.NX]),
        fom_tf=np.float64(fom.domain[fom.T]),
        fom_nt=np.int64(fom.domain[fom.NT]),
        fom_degree=np.int64(fom.mesh.degree),
        fom_bdf=np.array(fom.BDF_SCHEME), fom_which=np.array(which),
    )
    return payload


def clear_serving_caches(rom):
    rom._online_fns = {}
    rom._windowed_lanes_tbl = {}
    rom._windowed_pallas_tbl = None


@contextlib.contextmanager
def reference_serving(rom):
    """f32 serving scope of the reference's fused windowed path:
    ROMTIME_WINDOWED_KERNEL=fused, ROMTIME_SOLVE_ITERS=0 (LU), θ-streaming
    branch forced by a zero precompute budget (tests/test_windowed.py)."""
    saved = {k: os.environ.get(k) for k in ("ROMTIME_WINDOWED_KERNEL",
                                            "ROMTIME_SOLVE_ITERS")}
    budget = type(rom).ONLINE_PRECOMPUTE_BUDGET
    os.environ["ROMTIME_WINDOWED_KERNEL"] = "fused"
    os.environ["ROMTIME_SOLVE_ITERS"] = "0"
    clear_serving_caches(rom)
    try:
        type(rom).ONLINE_PRECOMPUTE_BUDGET = 0
        with compute_dtype_scope(jnp.float32):
            yield
    finally:
        type(rom).ONLINE_PRECOMPUTE_BUDGET = budget
        clear_serving_caches(rom)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def reference_solve(rom, mus, probe_reduce=None):
    with reference_serving(rom):
        return rom.solve_batch(mus, step=Stage.ONLINE, mode="probes",
                               engine="windowed-pallas",
                               probe_reduce=probe_reduce)


def reference_prep(rom, mus):
    """(tables, prepped) of the reference's stage 1, as numpy."""
    from romtime_tpu.dtypes import asarray

    with reference_serving(rom):
        names = sorted(mus[0].keys())
        batch = {k: asarray(np.array([float(mu[k]) for mu in mus]))
                 for k in names}
        tables = rom._windowed_pallas_tables()
        prepped = rom._windowed_pallas_prep(batch, tables)
        return ({k: np.asarray(v) for k, v in tables.items()},
                {k: np.asarray(v) for k, v in prepped.items()})
