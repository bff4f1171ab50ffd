"""Test-side helpers shared by the port's parity tests (not collected):
build the JAX piston cell, carry a JAX-built serving configuration across
to the PyTorch port, and run the reference's windowed serving on each
stage-2 branch the way tests/test_windowed.py runs it."""

import contextlib
import io
import os

import jax.numpy as jnp
import numpy as np

from romtime_tpu.conventions import Stage
from romtime_tpu.dtypes import compute_dtype_scope

#: The reference's trained reductors (HyperReducedPiston
#: attributes) whose POD spectra a parity cell must have finite.
TRAINED_REDUCTORS = ("deim_rhs", "mdeim_mass", "mdeim_stiffness",
                     "mdeim_convection", "mdeim_trilinear_lifting")


def _numpy_svd(a, full_matrices=False):
    return tuple(np.linalg.svd(np.asarray(a), full_matrices=full_matrices))


def build_piston_hrom(workdir):
    """The conftest windowed piston pipeline (nx=150, nt=96, W=4 windows
    of N=12 beside the global basis), built in ``workdir`` with the POD's
    SVD routed through numpy: the jax CPU SVD returns NaN spectra on some
    exactly-rank-1 snapshot matrices under threaded OpenBLAS (ROADMAP
    Queue 3), which leaves an MDEIM without dofs. Asserts that every
    trained reductor has finite spectra and every serving reductor dofs."""
    import pytest
    from conftest import _piston_windowed_setup

    from romtime_tpu.rom.hrom import HyperReducedPiston

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp.linalg, "svd", _numpy_svd)
        mp.chdir(workdir)
        hrom = HyperReducedPiston(**_piston_windowed_setup(),
                                  rnd=np.random.RandomState(0))
        hrom.setup()
        hrom.setup_hyperreduction()
        hrom.run_offline_rom()
        hrom.run_offline_hyperreduction(
            mu_space=hrom.mu_space[Stage.OFFLINE], evaluate=False)
        hrom.project_reductors()
        hrom.build_windowed_serving(n_windows=4, num_basis=12,
                                    srom_extra=4)
    for name in TRAINED_REDUCTORS:
        sigmas = getattr(hrom, name).sigmas
        assert sigmas is not None and np.isfinite(np.asarray(sigmas)).all(), (
            f"reference {name} has non-finite spectra")
    rom = hrom.rom
    serving = dict(rom._theta_sources(), trilinear=(rom.mdeim_Nh, None))
    for name, (red, _fb) in serving.items():
        assert red.dofs, f"reference {name} reductor has no dofs"
    return hrom


def piston_mus(B, seed=0):
    """B μ dicts drawn from the piston box (a0, ω, δ; α, γ fixed)."""
    rng = np.random.default_rng(seed)
    return [dict(a0=rng.uniform(8.0, 10.0), omega=rng.uniform(15.0, 20.0),
                 delta=rng.uniform(0.1, 0.15), alpha=1e-6, gamma=1.4)
            for _ in range(B)]


def assert_served_close(got, ref):
    """Windowed serving parity at tests/test_windowed.py:121-125's
    limits: probes 5e-6·scale, uN_final 5e-5."""
    assert np.isfinite(ref["probes"]).all()
    assert np.isfinite(ref["uN_final"]).all()
    assert got["probes"].shape == ref["probes"].shape
    scale = max(np.abs(ref["probes"]).max(), 1e-3)
    np.testing.assert_allclose(got["probes"], ref["probes"], rtol=0,
                               atol=5e-6 * scale)
    np.testing.assert_allclose(got["uN_final"], ref["uN_final"], rtol=0,
                               atol=5e-5)


def fom_payload(rom, which="rest"):
    """The ``fom_*`` keys of a payload."""
    fom = rom.fom
    return dict(
        fom_L0=np.float64(fom.domain[fom.L0]),
        fom_nx=np.int64(fom.domain[fom.NX]),
        fom_tf=np.float64(fom.domain[fom.T]),
        fom_nt=np.int64(fom.domain[fom.NT]),
        fom_degree=np.int64(fom.mesh.degree),
        fom_bdf=np.array(fom.BDF_SCHEME), fom_which=np.array(which),
    )


def _dofs_payload(rom):
    return {f"dofs_{name}": np.asarray(red.dofs, np.int64).reshape(
        len(red.dofs), -1) for name, (red, _fb) in rom._theta_sources().items()}


def grid_payload(rom):
    """The ``grid_<name>`` keys: the reference's μ box, (min, max) of each
    distribution's support, in its grid order."""
    return {f"grid_{k}": np.array([float(min(d.support())),
                                   float(max(d.support()))])
            for k, d in rom.grid.items()}


def _global_arrays(rom, with_trilinear=True):
    """Basis, each reductor's folded combine V·(PᵀU)⁻¹ on the ROM basis,
    its PᵀU and reduced collateral basis (the float64 θ-solve), and
    (optionally) the trilinear state table."""
    basis = np.asarray(rom.basis)
    out = {"basis": basis}
    for name, (red, _fb) in rom._theta_sources().items():
        out[f"combine_{name}"] = np.asarray(red._combine_matrix(red.ROM))
        out[f"PT_U_{name}"] = np.asarray(red.PT_U, np.float64)
        out[f"basis_rom_{name}"] = np.asarray(red.basis_rom, np.float64)
    if with_trilinear:
        out["trilinear"] = np.asarray(rom._trilinear_state_table(basis))
    return out


def npz_arrays(obj):
    """key → array of what ``obj.dump`` writes (a reference
    ``WindowedServing`` or ``MuLocalWindowed``)."""
    buf = io.BytesIO()
    obj.dump(buf)
    buf.seek(0)
    with np.load(buf) as data:
        return {k: data[k] for k in data.files}


def payload_from_rom(rom, which="rest", serving=None, with_trilinear=False):
    """The port's serving payload (romtime_tpu_torch.convert) from a JAX
    ``RomConstructorNonlinear`` with windowed serving attached, its global
    basis, combines, PᵀU and reduced collateral bases under the
    ``global_`` prefix (the pivot-free guard runs on them; the trilinear
    table, which the guard does not read, only ``with_trilinear``, for
    the global lanes engine). ``serving`` (default: the active windows)
    is what the payload serves: a reference ``MuLocalWindowed`` gives a
    fleet payload (``convert.fleet_serving_from_arrays``)."""
    payload = npz_arrays(rom.windows if serving is None else serving)
    payload.update(_dofs_payload(rom), **fom_payload(rom, which),
                   **grid_payload(rom))
    payload.update({f"global_{k}": v for k, v in
                    _global_arrays(rom, with_trilinear).items()})
    return payload


def global_payload_from_rom(rom, which="rest"):
    """The port's global serving payload (romtime_tpu_torch.convert) from
    a JAX ``RomConstructorNonlinear``: its basis, each reductor's folded
    combine V·(PᵀU)⁻¹ on the ROM basis and the trilinear state table."""
    return dict(_dofs_payload(rom), **fom_payload(rom, which),
                **grid_payload(rom), **_global_arrays(rom))


def estimator_payload_from_hrom(hrom, engine=None, fleet=None):
    """The port's estimator payload (``convert.estimator_from_arrays``)
    from a JAX ``HyperReducedPiston``: the global ROM and its S-ROM under
    ``srom_`` (default), the windowed ROM and ``windows_srom`` under
    ``srom_`` (``engine="windowed"``), or the fleet payload of ``fleet``,
    whose nested S-ROM cells travel in it."""
    rom = hrom.rom
    if fleet is not None:
        return payload_from_rom(rom, serving=fleet)
    if engine == "windowed":
        payload, srom = payload_from_rom(rom), npz_arrays(hrom.windows_srom)
    else:
        payload = global_payload_from_rom(rom)
        srom = {k: v for k, v in _global_arrays(hrom.srom).items()
                if not k.startswith("PT_U_")}
    payload.update({f"srom_{k}": v for k, v in srom.items()})
    return payload


def clear_serving_caches(rom):
    rom._online_fns = {}
    rom._windowed_lanes_tbl = {}
    rom._windowed_pallas_tbl = None


#: Stage-2 branches of windowed serving (rom/engines/windowed_pallas.py
#: :310-488): "matrices" keeps the precompute budget as it is (the tables
#: of a test batch fit it), "fused" and "v2" zero it and set
#: ROMTIME_WINDOWED_KERNEL.
BRANCHES = ("matrices", "fused", "v2")


@contextlib.contextmanager
def reference_serving(rom, branch="matrices", solve_iters="0"):
    """f32 serving scope of the reference's windowed-pallas engine on
    ``branch``, with ROMTIME_SOLVE_ITERS=``solve_iters`` ("0": the LU, as
    tests/test_windowed.py runs it; None: unset, the auto policy)."""
    if branch not in BRANCHES:
        raise ValueError(f"unknown branch {branch!r}")
    saved = {k: os.environ.get(k) for k in ("ROMTIME_WINDOWED_KERNEL",
                                            "ROMTIME_SOLVE_ITERS")}
    budget = type(rom).ONLINE_PRECOMPUTE_BUDGET
    if solve_iters is None:
        os.environ.pop("ROMTIME_SOLVE_ITERS", None)
    else:
        os.environ["ROMTIME_SOLVE_ITERS"] = solve_iters
    if branch != "matrices":
        os.environ["ROMTIME_WINDOWED_KERNEL"] = branch
    clear_serving_caches(rom)
    try:
        if branch != "matrices":
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


def reference_solve(rom, mus, probe_reduce=None, branch="matrices",
                    solve_iters="0"):
    with reference_serving(rom, branch, solve_iters):
        return rom.solve_batch(mus, step=Stage.ONLINE, mode="probes",
                               engine="windowed-pallas",
                               probe_reduce=probe_reduce)


def port_branch(port, branch, monkeypatch):
    """Put the port's serving object on ``branch`` (the budget on the
    instance, the kernel switch through ``monkeypatch``)."""
    if branch != "matrices":
        port.ONLINE_PRECOMPUTE_BUDGET = 0
        monkeypatch.setenv("ROMTIME_WINDOWED_KERNEL", branch)
    return port


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
