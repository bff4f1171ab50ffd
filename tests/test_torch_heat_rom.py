"""The port's heat ROM (romtime_tpu_torch/rom/rom.py ``RomConstructor``)
against the JAX package: the ROM of tests/test_rom.py:20-80 (nx=100,
nt=100, 10 μ each), built by the JAX package, carried across as numpy
(``convert.global_serving_from_arrays``) and served by both: the
single-μ solve, the batch modes (:80-170), the global kernels at
``with_trilinear=False`` and BDF-1, K4's and K5's twins against the
interpreted reference kernels (:175-241; probes 3e-5·scale and
``uN_final`` 1e-4·max(|uN|, 1) against the lanes engine, K5 within
3e-6·scale of K4), the gate; the f32 drift of tests/test_dtypes.py:45,
the base family's right-hand side and truncation on the port's own
build.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from romtime_tpu.conventions import OperatorType as RefOperatorType
from romtime_tpu.conventions import Stage as RefStage
from romtime_tpu.dtypes import compute_dtype_scope as ref_dtype_scope
from romtime_tpu_torch import global_serving_from_arrays
from romtime_tpu_torch.conventions import Stage
from romtime_tpu_torch.dtypes import compute_dtype_scope
from romtime_tpu_torch.parameters import ParameterSampler
from romtime_tpu_torch.rom import RomConstructor
from romtime_tpu_torch.rom.engines import global_fused
from test_torch_heat import (
    F64,
    _mu_t,
    port_grid,
    port_solver,
    ref_grid,
    ref_solver,
)
from torch_parity import _numpy_svd, heat_payload_from_rom

jax.config.update("jax_enable_x64", True)


# ---------------------------------------------------------------------------
# The ROM of tests/test_rom.py (nx=100, nt=100)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def heat_rom():
    """tests/test_rom.py:20-77's trained ROM, built by the JAX package
    (RHS-DEIM, mass and stiffness MDEIM, 10 μ each, projected), and the
    port's serving object from its arrays."""
    from romtime_tpu.deim import (
        DiscreteEmpiricalInterpolation,
        MatrixDiscreteEmpiricalInterpolation,
    )
    from romtime_tpu.rom import RomConstructor as RefRom

    fom = ref_solver(2.0, 100, 100, 10.0,
                     mu=dict(delta=1.0, beta=5.0, alpha_0=1.0))
    rnd = np.random.RandomState(0)
    mp = pytest.MonkeyPatch()
    # The jax CPU SVD returns NaN spectra on some rank-1 snapshot
    # matrices (ROADMAP Queue 3): the reference's build goes through numpy.
    mp.setattr(jnp.linalg, "svd", _numpy_svd)
    tw = {"ts": np.linspace(0.1, 10.0, 100), "num_snapshots": 10}
    reds = []
    for cls, name, assemble in (
            (DiscreteEmpiricalInterpolation, "RHS", fom.assemble_rhs),
            (MatrixDiscreteEmpiricalInterpolation, "Stiffness",
             fom.assemble_stiffness),
            (MatrixDiscreteEmpiricalInterpolation, "Mass",
             fom.assemble_mass)):
        red = cls(name=name, assemble=assemble, grid=ref_grid(),
                  tree_walk_params=tw)
        red.setup(rnd=rnd)
        red.run()
        reds.append(red)
    rom = RefRom(fom=fom, grid=ref_grid())
    rom.setup(rnd=rnd)
    rom.build_reduced_basis(num_snapshots=10)
    for red, which in zip(reds, (RefOperatorType.RHS,
                                 RefOperatorType.STIFFNESS,
                                 RefOperatorType.MASS)):
        rom.add_hyper_reductor(reductor=red, which=which)
    rom.project_reductors()
    mp.undo()
    port = global_serving_from_arrays(heat_payload_from_rom(rom),
                                      device="cpu")
    return rom, port


def heat_mus(num, seed):
    return [dict(mu) for mu in ParameterSampler(
        port_grid(), n_iter=num, random_state=np.random.RandomState(seed))]


def test_carried_rom_is_the_base_family(heat_rom):
    """The payload's problem picks the family: the base ROM, three θ
    sources, the rhs fallback forcing + lifting, no trilinear table."""
    _ref, port = heat_rom
    assert type(port) is RomConstructor
    assert tuple(port._theta_sources()) == ("mass", "stiffness", "rhs_vec")
    assert port.FALLBACKS["rhs_vec"] == "assemble_rhs"
    assert port.global_serving.trilinear is None
    assert port._lanes_supported()


def test_solve_matches_reference(heat_rom):
    """rom.solve(mu) in float64 against the JAX package's (the hoisted θ,
    the BDF-1 loop, the lifting and the exact-solution errors):
    1e-10·scale; the online errors within the golden band of
    tests/test_rom.py:96-112."""
    ref, port = heat_rom
    errors = []
    for mu in heat_mus(4, 1):
        with ref_dtype_scope(jnp.float64):
            ref.solve(mu=mu, step=RefStage.ONLINE)
        with compute_dtype_scope(F64):
            idx = port.solve(mu, Stage.ONLINE)
        want = np.asarray(ref.solutions.fom)
        scale = np.abs(want).max()
        assert np.abs(port.solutions.fom - want).max() <= 1e-10 * scale
        assert_allclose(port.solutions.rom, np.asarray(ref.solutions.rom),
                        atol=1e-10 * np.abs(ref.solutions.rom).max())
        errors.append(port.errors[idx])
    assert np.median(errors) < 1e-3 and np.mean(errors) < 0.1


def test_solve_batch_modes(heat_rom):
    """tests/test_rom.py:115-170: the full batch ≡ serial solves (1e-12),
    the reduced mode's coefficients and end probes, the probes mode
    against the reduced sweep (1e-14)."""
    _ref, port = heat_rom
    mus = heat_mus(4, 7)
    with compute_dtype_scope(F64):
        full = port.solve_batch(mus, mode="full")
        red = port.solve_batch(mus, mode="reduced")
        served = port.solve_batch(mus, mode="probes")
        for i, mu in enumerate(mus):
            port.solve(mu, Stage.ONLINE)
            assert_allclose(full["uc"][i].T, port.solutions.fom, atol=1e-12)
            assert_allclose(full["uN"][i].T, port.solutions.rom, atol=1e-12)
    assert_allclose(red["uN"], full["uN"], atol=1e-12)
    assert "uc" not in red
    assert_allclose(red["probes"][..., 0], full["uc"][..., 0], atol=1e-10)
    assert_allclose(red["probes"][..., 1], full["uc"][..., -1], atol=1e-10)
    assert "uN" not in served
    assert_allclose(served["probes"], red["probes"], atol=1e-14)
    assert_allclose(served["uN_final"], red["uN"][:, -1, :], atol=1e-14)


def test_assemble_system_delegates(heat_rom):
    """tests/test_rom.py:135-152: K_N = bdf·M_N + dt·A_N from the same
    reduced operators; the reduced right-hand side (the base family's:
    forcing + lifting through the RHS-DEIM) equals the JAX package's."""
    ref, port = heat_rom
    mu = heat_mus(1, 3)[0]
    t = 0.37 * port.fom.domain[port.fom.T]
    with compute_dtype_scope(F64):
        MN, KN = port.assemble_system(mu=mu, t=t, bdf=1.5)
        M_ref = port.assemble_mass(mu=mu, t=t)
        A_ref = port.assemble_stiffness(mu=mu, t=t)
        fN = port.assemble_rhs(mu=mu, t=t).numpy()
    assert_allclose(MN.numpy(), M_ref.numpy(), atol=1e-14)
    assert_allclose(KN.numpy(), 1.5 * M_ref.numpy()
                    + port.fom.dt * A_ref.numpy(), atol=1e-14)
    with ref_dtype_scope(jnp.float64):
        want = np.asarray(ref.assemble_rhs(
            {k: jnp.float64(v) for k, v in mu.items()}, jnp.float64(t)))
    assert_allclose(fN, want, atol=1e-10 * np.abs(want).max())


def _ref_pallas(ref, mus, budget=None):
    cls = type(ref)
    saved = cls.ONLINE_PRECOMPUTE_BUDGET
    ref._online_fns = {}
    try:
        if budget is not None:
            cls.ONLINE_PRECOMPUTE_BUDGET = budget
        with ref_dtype_scope(jnp.float32):
            return ref.solve_batch(mus, step=RefStage.ONLINE, mode="probes",
                                   engine="pallas")
    finally:
        cls.ONLINE_PRECOMPUTE_BUDGET = saved
        ref._online_fns = {}


def _close(got, want, rel_probes, rel_uN=None):
    scale = max(np.abs(want["probes"]).max(), 1e-6)
    assert np.abs(got["probes"] - want["probes"]).max() <= rel_probes * scale
    if rel_uN is not None:
        uscale = max(np.abs(want["uN_final"]).max(), 1.0)
        assert (np.abs(got["uN_final"] - want["uN_final"]).max()
                <= rel_uN * uscale)


def test_global_kernels_without_trilinear(heat_rom, monkeypatch):
    """tests/test_rom.py:175-241 on the port: B=128 f32 served through
    K4's twin (materialized, the default budget) and K5's twin (budget
    0) at ``with_trilinear=False`` and BDF-1, each against the
    interpreted reference kernel on the same μ (probes 3e-5·scale,
    ``uN_final`` 1e-4·max(|uN|, 1)) and against the port's float32 lanes
    engine; K5 within 3e-6·scale of K4."""
    ref, port = heat_rom
    mus = (heat_mus(4, 9) * 32)[:128]
    seen = []
    for name in ("online_sweep_pallas", "online_sweep_theta_pallas"):
        real = getattr(global_fused, name)

        def spy(*args, _real=real, _name=name, **kw):
            seen.append((_name, kw["with_trilinear"], kw["bdf2"]))
            return _real(*args, **kw)

        monkeypatch.setattr(global_fused, name, spy)
    lanes = port.solve_batch(mus, mode="probes", engine="lanes")
    k4 = port.solve_batch(mus, mode="probes")
    port.ONLINE_PRECOMPUTE_BUDGET = 0
    k5 = port.solve_batch(mus, mode="probes")
    del port.ONLINE_PRECOMPUTE_BUDGET
    assert seen == [("online_sweep_pallas", False, False),
                    ("online_sweep_theta_pallas", False, False)]
    for got, budget in ((k4, None), (k5, 0)):
        _close(got, _ref_pallas(ref, mus, budget), 3e-5, 1e-4)
        _close(got, lanes, 3e-5, 1e-4)
    _close(k5, k4, 3e-6)


def test_engine_gate(heat_rom):
    """tests/test_rom.py:244-255 and pallas_global.py:49-66: a linear
    family serves through the global kernels with no trilinear table in
    float32 on whole 128-lane blocks; float64 or a ragged batch take the
    lanes engine; the gate still refuses the piston family without it."""
    _ref, port = heat_rom
    with compute_dtype_scope(F64):
        assert port._resolve_engine("probes", 128) == "lanes"
    assert port._resolve_engine("probes", 128) == "pallas"
    assert port._resolve_engine("probes", 100) == "lanes"
    assert global_fused.supported(128, 10, torch.float32, False, False)
    assert not global_fused.supported(128, 10, torch.float32, True, False)


def test_ports_build_drift_rhs_and_truncate():
    """The port's own Galerkin build (no hyper-reduction: every operator
    projected, tests/test_dtypes.py:45): float32 within 1e-5 of float64,
    float64 within 1e-9·scale of the JAX package's build; the reduced
    right-hand side is the projected forcing + lifting (the base
    family's fallback); the truncated ROM keeps its family and solves
    as the JAX package's truncated ROM (tests/test_rom.py:258-272)."""
    from romtime_tpu.rom import RomConstructor as RefRom

    mu0 = dict(delta=1.0, beta=5.0, alpha_0=1.0)
    fom = port_solver(2.0, 60, 40, 10.0, mu=mu0)
    rom = RomConstructor(fom=fom, grid=port_grid(), device="cpu")
    rom.setup(rnd=np.random.RandomState(0))
    rom.build_reduced_basis(num_snapshots=4)
    mu = rom.mu_space[Stage.OFFLINE][0]
    with compute_dtype_scope(F64):
        rom.solve(mu=mu, step=Stage.ONLINE)
        fN = rom.assemble_rhs(mu, 2.5).numpy()
        f_proj = rom.to_rom(fom.assemble_forcing(*_mu_t(mu, 2.5))
                            + fom.assemble_lifting(*_mu_t(mu, 2.5))).numpy()
    u64 = rom.solutions.fom
    rom.solve(mu=mu, step=Stage.ONLINE)
    u32 = rom.solutions.fom
    assert u32.dtype == np.float32
    assert np.linalg.norm(u32 - u64) / np.linalg.norm(u64) < 1e-5
    assert_allclose(fN, f_proj, atol=1e-12 * np.abs(f_proj).max())

    ref = RefRom(fom=ref_solver(2.0, 60, 40, 10.0, mu=mu0), grid=ref_grid())
    ref.setup(rnd=np.random.RandomState(0))
    with ref_dtype_scope(jnp.float64):
        ref.build_reduced_basis(num_snapshots=4)
        ref.solve(mu=ref.mu_space[RefStage.OFFLINE][0],
                  step=RefStage.ONLINE)
        want = np.asarray(ref.solutions.fom)
        assert np.abs(u64 - want).max() <= 1e-9 * np.abs(want).max()
        ref_t = ref.truncate(n=2)
        ref_t.solve(mu=ref.mu_space[RefStage.OFFLINE][0],
                    step=RefStage.ONLINE)
    trunc = rom.truncate(n=2)
    assert type(trunc) is RomConstructor and trunc.N == rom.N - 2
    with compute_dtype_scope(F64):
        trunc.solve(mu=mu, step=Stage.ONLINE)
    want = np.asarray(ref_t.solutions.fom)
    assert np.abs(trunc.solutions.fom - want).max() <= (
        1e-9 * np.abs(want).max())
