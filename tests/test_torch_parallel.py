"""The port's multi-device layer (romtime_tpu_torch/parallel: the μ mesh,
TSQR POD, the sharded FOM and online sweeps, ``build_reduced_basis``'s
``mesh=`` and the dry run) against the JAX package on the CPU.

Mirrors tests/test_parallel.py:27-160: the port runs on
``DeviceMesh([cpu] * 8)`` (eight shards in turn on one device), the JAX
package on its eight virtual CPU devices (tests/conftest.py), both on
the same numpy-seeded inputs in float64. Limits: TSQR's σ within 1e-10
of LAPACK's relative to σ₁ and its leading vectors up to column signs
(|overlap| within 1e-8 of 1); the sharded sweeps within 1e-12 of the
one-batch sweeps and of the JAX package's sharded sweeps; the sharded
basis build within tests/test_parallel.py:164's atol 1e-8 of the serial
build and, up to column signs, of the JAX package's; the dry run's
diagnostics at 8 and 2 shards within 1e-12 relative of one shard's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from romtime_tpu.fom import OneDimensionalBurgers as RefBurgers
from romtime_tpu.parallel import device_mesh as ref_device_mesh
from romtime_tpu.parallel import orth_distributed as ref_orth_distributed
from romtime_tpu.parallel import solve_fom_sharded as ref_solve_fom_sharded
from romtime_tpu.parallel import solve_online_sharded as ref_solve_online
from romtime_tpu.parallel import tsqr_svd as ref_tsqr_svd
from romtime_tpu.problems import define_piston_problem as ref_problem
from romtime_tpu.rom import RomConstructorNonlinear as RefRCN
from romtime_tpu_torch.dtypes import compute_dtype_scope
from romtime_tpu_torch.fom import OneDimensionalBurgers
from romtime_tpu_torch.parallel import (
    MU_AXIS,
    DeviceMesh,
    device_mesh,
    mu_sharding,
    orth_distributed,
    replicated,
    solve_fom_batch,
    solve_fom_sharded,
    solve_online_sharded,
    tsqr_svd,
)
from romtime_tpu_torch.parallel import dryrun
from romtime_tpu_torch.parameters import get_uniform_dist
from romtime_tpu_torch.problems import define_piston_problem
from romtime_tpu_torch.rom import RomConstructorNonlinear
from torch_parity import _numpy_svd

CPU = torch.device("cpu")
MESHES = {"8": DeviceMesh([CPU] * 8), "3": DeviceMesh([CPU] * 3),
          "1": DeviceMesh([CPU])}
GRID = dict(L=1.0, nx=64, tf=0.2, nt=20)
MU0 = dict(a0=10.0, omega=18.0, alpha=1e-6, delta=0.12, gamma=1.4)


@pytest.fixture(scope="module")
def ref_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("Needs 8 virtual devices (see conftest XLA_FLAGS).")
    return ref_device_mesh(8)


@pytest.fixture
def f64():
    with compute_dtype_scope(torch.float64):
        yield


@pytest.fixture(scope="module")
def solvers():
    d, bcs, forcing, u0, Lt, dLt = ref_problem(**GRID)
    ref = RefBurgers(domain=d, dirichlet=bcs, parameters=dict(MU0),
                     forcing_term=forcing, u0=u0, Lt=Lt, dLt_dt=dLt)
    ref.setup()
    d, bcs, forcing, u0, Lt, dLt = define_piston_problem(**GRID)
    port = OneDimensionalBurgers(domain=d, dirichlet=bcs,
                                 parameters=dict(MU0), forcing_term=forcing,
                                 u0=u0, Lt=Lt, dLt_dt=dLt, device="cpu")
    port.setup()
    return ref, port


def _mus(n, seed=0):
    rng = np.random.default_rng(seed)
    return [dict(a0=rng.uniform(8, 10), omega=rng.uniform(15, 20),
                 delta=rng.uniform(0.1, 0.15), alpha=1e-6, gamma=1.4)
            for _ in range(n)]


def _align_signs(U, ref):
    """U's columns flipped to ref's signs."""
    return U * np.sign(np.sum(U * ref, axis=0))


# ----------------------------------------------------------------------
# The mesh
# ----------------------------------------------------------------------
def test_device_mesh_repeats_and_split():
    mesh = DeviceMesh(["cpu", CPU, "cpu"])
    assert mesh.size == 3 and mesh.devices == (CPU,) * 3
    assert MU_AXIS == "mu"
    split = mu_sharding(mesh, 6)
    assert [d for d, _ in split] == [CPU] * 3
    assert [(s.start, s.stop) for _, s in split] == [(0, 2), (2, 4), (4, 6)]
    with pytest.raises(ValueError):
        mu_sharding(mesh, 7)
    x = torch.arange(4.0)
    copies = replicated(mesh, x)
    assert len(copies) == 3 and all(c is copies[0] for c in copies)
    assert torch.equal(copies[0], x)
    with pytest.raises(ValueError):
        DeviceMesh([])


def test_device_mesh_never_falls_back():
    """``device_mesh`` lists distinct devices of the asked type and
    raises where there are fewer; without a card it does not fall back
    to the CPU."""
    assert device_mesh(device_type="cpu").devices == (CPU,)
    with pytest.raises(RuntimeError):
        device_mesh(2, device_type="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            device_mesh()
        with pytest.raises(RuntimeError):
            DeviceMesh(["cuda"])
    with pytest.raises(ValueError):
        device_mesh(device_type="tpu")


# ----------------------------------------------------------------------
# TSQR (tests/test_parallel.py:27-51)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("m", [64, 61])
@pytest.mark.parametrize("mesh", ["8", "3", "1"])
def test_tsqr_svd_matches_dense(ref_mesh, monkeypatch, mesh, m):
    rng = np.random.default_rng(0)
    nh = 40
    U0 = np.linalg.qr(rng.normal(size=(nh, nh)))[0]
    s0 = np.logspace(0, -12, nh)
    S = U0 @ np.diag(s0) @ rng.normal(size=(nh, m))

    U, s = tsqr_svd(S, mesh=MESHES[mesh])
    assert U.dtype == np.float64 and U.shape == (nh, nh)

    Ud, s_ref, _ = np.linalg.svd(S, full_matrices=False)
    assert_allclose(s[: len(s_ref)], s_ref, rtol=0, atol=1e-10 * s_ref[0])
    k = 5
    overlap = np.abs(np.diag(U[:, :k].T @ Ud[:, :k]))
    assert_allclose(overlap, 1.0, atol=1e-8)

    monkeypatch.setattr(jnp.linalg, "svd", _numpy_svd)
    U_j, s_j = ref_tsqr_svd(S, mesh=ref_mesh)
    assert_allclose(s, s_j, rtol=0, atol=1e-10 * s_j[0])
    assert_allclose(_align_signs(U[:, :k], U_j[:, :k]), U_j[:, :k],
                    atol=1e-8)


@pytest.mark.parametrize("kw", [dict(num=4, normalize=False),
                                dict(num=4), dict(tol=0.9), dict()])
def test_orth_distributed_truncation(ref_mesh, monkeypatch, kw):
    rng = np.random.default_rng(1)
    S = rng.normal(size=(30, 24))
    Q, s, energy = orth_distributed(S, mesh=MESHES["8"], **kw)
    if "num" in kw:
        assert Q.shape == (30, 4)
    assert_allclose(Q.T @ Q, np.eye(Q.shape[1]), atol=1e-10)

    monkeypatch.setattr(jnp.linalg, "svd", _numpy_svd)
    Q_j, s_j, e_j = ref_orth_distributed(S, mesh=ref_mesh, **kw)
    assert Q.shape == Q_j.shape
    assert_allclose(s, s_j, rtol=0, atol=1e-10 * s_j[0])
    assert_allclose(energy, e_j, rtol=1e-10)
    assert_allclose(_align_signs(Q, Q_j), Q_j, atol=1e-8)


def test_orth_distributed_matches_orth():
    """The TSQR backend keeps ``rom.pod.orth``'s truncation, drop floor
    included, on a rank-deficient stack."""
    from romtime_tpu_torch.rom.pod import orth

    rng = np.random.default_rng(2)
    S = rng.normal(size=(50, 6)) @ rng.normal(size=(6, 40))
    Q, s, energy = orth_distributed(S, mesh=MESHES["3"])
    Q_o, s_o, e_o = orth(S)
    assert Q.shape == Q_o.shape == (50, 6)
    assert_allclose(s[:6], s_o[:6], rtol=1e-10)
    assert_allclose(_align_signs(Q, Q_o), Q_o, atol=1e-8)


# ----------------------------------------------------------------------
# The sharded FOM sweep (tests/test_parallel.py:84-98)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n,seed", [(8, 0), (5, 3)])
def test_fom_sweep_sharded_matches_batch(ref_mesh, solvers, f64, n, seed):
    ref, port = solvers
    mus = _mus(n, seed)
    outs_b = solve_fom_batch(port, mus)
    calls = []
    impl = port._solve_impl
    port._solve_impl = lambda mu: (calls.append(
        next(iter(mu.values())).shape[0]), impl(mu))[1]
    try:
        outs_s = solve_fom_sharded(port, mus, mesh=MESHES["8"])
    finally:
        del port._solve_impl
    assert calls == [1] * 8
    assert set(outs_s) == set(outs_b)
    for k in outs_b:
        assert outs_s[k].shape == outs_b[k].shape
        assert outs_s[k].shape[0] == n
        assert_allclose(outs_s[k], outs_b[k], rtol=0, atol=1e-12)
    outs_j = ref_solve_fom_sharded(ref, mus, mesh=ref_mesh)
    for k in ("uh", "uc", "probes", "nonlinear_data"):
        scale = np.abs(outs_j[k]).max()
        assert_allclose(outs_s[k], outs_j[k], rtol=0, atol=1e-12 * scale)


# ----------------------------------------------------------------------
# The sharded online sweep (tests/test_parallel.py:101-117)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["reduced", "probes"])
def test_online_sweep_sharded(ref_mesh, solvers, f64, mode):
    ref, port = solvers
    rng = np.random.default_rng(0)
    V = np.linalg.qr(rng.normal(size=(port.mesh.nh, 4)))[0]
    rom = RomConstructorNonlinear(fom=port, grid=None, device="cpu")
    rom.setup(rnd=0)
    rom.basis = V
    rom_j = RefRCN(fom=ref, grid=None)
    rom_j.setup(rnd=0)
    rom_j.basis = V

    mus = _mus(8, seed=5)
    serial = rom.solve_batch(mus, mode=mode)
    sharded = solve_online_sharded(rom, mus, mesh=MESHES["8"], mode=mode)
    ref_out = ref_solve_online(rom_j, mus, mesh=ref_mesh, mode=mode)
    assert set(sharded) == set(ref_out)
    for k, v in ref_out.items():
        assert sharded[k].shape == v.shape, k
        assert_allclose(sharded[k], v, rtol=0, atol=1e-12)
        if k != "t":
            assert_allclose(sharded[k], serial[k], rtol=0, atol=1e-12)


# ----------------------------------------------------------------------
# build_reduced_basis(mesh=...) (tests/test_parallel.py:137-169)
# ----------------------------------------------------------------------
def _grid(dist):
    return {"a0": dist(min=8.0, max=10.0), "omega": dist(min=15.0, max=20.0),
            "delta": dist(min=0.1, max=0.15), "alpha": dist(min=1e-6,
                                                           max=1e-6),
            "gamma": dist(min=1.4, max=1.4)}


def test_build_reduced_basis_device_sweep(ref_mesh, solvers, monkeypatch,
                                          tmp_path, f64):
    from romtime_tpu.parameters import get_uniform_dist as ref_dist

    monkeypatch.chdir(tmp_path)
    ref, port = solvers

    def build(cls, fom, grid, device_sweep, mesh, **kw):
        rom = cls(fom=fom, grid=grid, **kw)
        rom.setup(rnd=np.random.RandomState(5))
        rom.build_reduced_basis(num_snapshots=3, num_basis=6,
                                device_sweep=device_sweep, mesh=mesh)
        return rom

    grid = _grid(get_uniform_dist)
    serial = build(RomConstructorNonlinear, port, grid, False, None,
                   device="cpu")
    sharded = build(RomConstructorNonlinear, port, grid, True,
                    MESHES["8"], device="cpu")
    assert sharded.basis.shape == serial.basis.shape
    assert_allclose(sharded.basis, serial.basis, atol=1e-8)
    assert_allclose(sharded.basis_nonlinear, serial.basis_nonlinear,
                    atol=1e-8)
    assert len(sharded.offline_snapshots) == 3
    assert sharded.offline_snapshots_build == "f64"

    monkeypatch.setattr(jnp.linalg, "svd", _numpy_svd)
    ref_rom = build(RefRCN, ref, _grid(ref_dist), True, ref_mesh)
    assert_allclose(_align_signs(sharded.basis, ref_rom.basis),
                    ref_rom.basis, atol=1e-8)


# ----------------------------------------------------------------------
# The dry run (tests/test_parallel.py:120-134)
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def serving_rom():
    return dryrun.serving_hrom("cpu").rom


@pytest.mark.parametrize("n", [8, 2])
def test_dryrun_multichip(serving_rom, n):
    mesh = DeviceMesh([CPU] * n)
    value, served = dryrun.dryrun_multichip(mesh, rom=serving_rom)
    assert np.isfinite(value) and np.isfinite(served)
    with compute_dtype_scope(torch.float64):
        solver = dryrun.tiny_piston(device="cpu")
        sharded = dryrun.training_step(solver, dryrun.dryrun_batch(n), mesh)
        one = dryrun.training_step(solver, dryrun.dryrun_batch(n),
                                   MESHES["1"])
    assert_allclose(sharded, one, rtol=1e-12)
    assert_allclose(served, dryrun.serving_step(
        serving_rom, dryrun.serving_mus(n), MESHES["1"]), rtol=1e-12)
