"""The mock (M)DEIM trainings of the heat family
(romtime_tpu_torch/testing/mock.py, fom/heat.py) against the JAX
package: tests/test_deim.py:41-152 and tests/test_mdeim.py:36-80,
:141-229, the port's dofs against the JAX package's and its
interpolation at the reference's limits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from romtime_tpu.dtypes import compute_dtype_scope as ref_dtype_scope
from romtime_tpu_torch.conventions import Stage
from romtime_tpu_torch.dtypes import compute_dtype_scope
from romtime_tpu_torch.fom import HeatEquationMovingSolver
from romtime_tpu_torch.parameters import ParameterSampler, get_uniform_dist
from romtime_tpu_torch.problems import define_mfp1_problem
from test_torch_heat import F64, _mu_t, port_grid, ref_grid

jax.config.update("jax_enable_x64", True)


# ---------------------------------------------------------------------------
# The mock (M)DEIM trainings
# ---------------------------------------------------------------------------
def _forcing_torch(x, t, beta=None, delta=None, alpha_0=None, **mu):
    decay = torch.exp(-beta * t)
    return beta * decay * (1.0 + delta * delta * x * x) - (
        2.0 * delta * delta * alpha_0 * (1.0 - decay))


def _forcing_jax(x, t, beta=None, delta=None, alpha_0=None, **mu):
    decay = jnp.exp(-beta * t)
    return beta * decay * (1.0 + delta * delta * x * x) - (
        2.0 * delta * delta * alpha_0 * (1.0 - decay))


MOCK_DOMAIN = {"L0": 1.0, "nx": 100, "T": 5.0, "nt": 100}


def _mocks(forcing=True):
    from romtime_tpu.testing import MockSolver as RefMock
    from romtime_tpu_torch.testing.mock import MockSolver

    port = MockSolver(domain=MOCK_DOMAIN, dirichlet=None,
                      forcing_term=_forcing_torch if forcing else None,
                      device="cpu")
    ref = RefMock(domain=MOCK_DOMAIN, dirichlet=None,
                  forcing_term=_forcing_jax if forcing else None)
    port.setup()
    ref.setup()
    return port, ref


def _train(cls_port, cls_ref, port_assemble, ref_assemble, tw):
    port = cls_port(name="op", assemble=port_assemble, grid=port_grid(),
                    tree_walk_params=tw)
    ref = cls_ref(name="op", assemble=ref_assemble, grid=ref_grid(),
                  tree_walk_params=tw)
    port.setup(rnd=np.random.RandomState(0))
    ref.setup(rnd=np.random.RandomState(0))
    port.run()
    with ref_dtype_scope(jnp.float64):
        ref.run()
    return port, ref


def test_mock_deim_tree_walk():
    """tests/test_deim.py:41-77: the forcing DEIM of the mock solver,
    exact (1e-15) on a training and an unseen μ, the online error sweep
    under 1e-15, the same dofs as the JAX package's; a batch assembly
    equals the serial one (:80-97)."""
    from romtime_tpu.deim import DiscreteEmpiricalInterpolation as RefDEIM
    from romtime_tpu_torch.deim import DiscreteEmpiricalInterpolation

    solver, ref_solver_ = _mocks()
    tw = {"ts": np.linspace(0, 5.0, 20), "num_snapshots": 50}
    deim, ref = _train(DiscreteEmpiricalInterpolation, RefDEIM,
                       solver.assemble_forcing, ref_solver_.assemble_forcing,
                       tw)
    assert [tuple(int(v) for v in d) for d in deim.dofs] == [
        tuple(int(v) for v in d) for d in ref.dofs]
    unseen = list(ParameterSampler(port_grid(), n_iter=50,
                                   random_state=np.random.RandomState(19219)))
    with compute_dtype_scope(F64):
        for mu, t in ((deim.mu_space[Stage.OFFLINE][0], 1.0),
                      (unseen[0], 0.5)):
            expected = solver.assemble_forcing(*_mu_t(mu, t)).numpy()
            assert_allclose(expected, deim._interpolate(mu=mu, t=t),
                            atol=1e-15)
        deim.evaluate(num=20, ts=tw["ts"])
        ts = np.linspace(0.5, 5.0, 7)
        mu = unseen[1]
        batch = deim.assemble_snapshots_batch(mu, ts)
        for i, t in enumerate(ts):
            assert_allclose(batch[:, i],
                            solver.assemble_forcing(*_mu_t(mu, t)).numpy(),
                            atol=1e-15)
    errors = np.concatenate([np.atleast_1d(v) for v in
                             deim.errors_rom.values() if np.size(v)])
    assert errors.mean() < 1e-15


def test_mock_deim_copy_and_persistence(tmp_path):
    """tests/test_deim.py:100-143: a copy carries the trained state, the
    dump/load round trip rebuilds the interpolation (1e-15), the
    projection onto a solution basis gives (N, k); the dofs are the JAX
    package's."""
    from romtime_tpu.deim import DiscreteEmpiricalInterpolation as RefDEIM
    from romtime_tpu_torch.deim import DiscreteEmpiricalInterpolation
    from romtime_tpu_torch.utils import read_pickle

    solver, ref_solver_ = _mocks()
    tw = {"ts": np.linspace(0, 5.0, 10), "num_snapshots": 10}
    deim, ref = _train(DiscreteEmpiricalInterpolation, RefDEIM,
                       solver.assemble_forcing, ref_solver_.assemble_forcing,
                       tw)
    assert [tuple(int(v) for v in d) for d in deim.dofs] == [
        tuple(int(v) for v in d) for d in ref.dofs]
    other = deim.copy()
    assert np.allclose(other.basis_fom, deim.basis_fom)
    assert other.dofs == deim.dofs
    path = str(tmp_path / "basis.pkl")
    deim.dump_fom_basis(path=path)
    fresh = DiscreteEmpiricalInterpolation(
        name="op", assemble=solver.assemble_forcing, grid=port_grid(),
        tree_walk_params=tw)
    fresh.setup(rnd=np.random.RandomState(0))
    fresh.load_fom_basis(basis=read_pickle(path))
    mu = deim.mu_space[Stage.OFFLINE][0]
    with compute_dtype_scope(F64):
        assert_allclose(fresh._interpolate(mu=mu, t=1.0),
                        deim._interpolate(mu=mu, t=1.0), atol=1e-15)
    V = np.linalg.qr(np.random.default_rng(0).normal(
        size=(solver.mesh.nh, 5)))[0]
    deim.project_basis(V)
    assert deim.basis_rom.shape == (5, deim.N)


@pytest.mark.parametrize("operator", ["stiffness", "mass", "convection"])
def test_mock_mdeim_tree_walk(operator):
    """tests/test_mdeim.py:52-80: the mock solver's MDEIM per operator,
    exact (1e-12·scale) at a training μ, the same dofs as the JAX
    package's (as sets: the rank-1 families tie up to rounding)."""
    from romtime_tpu.deim import MatrixDiscreteEmpiricalInterpolation as Ref
    from romtime_tpu_torch.deim import MatrixDiscreteEmpiricalInterpolation

    solver, ref_solver_ = _mocks(forcing=False)
    tw = {"ts": np.linspace(0, 5.0, 20), "num_snapshots": 10}
    mdeim, ref = _train(MatrixDiscreteEmpiricalInterpolation, Ref,
                        getattr(solver, f"assemble_{operator}"),
                        getattr(ref_solver_, f"assemble_{operator}"), tw)
    assert mdeim.N == ref.N
    assert ({tuple(int(v) for v in d) for d in mdeim.dofs}
            == {tuple(int(v) for v in d) for d in ref.dofs})
    mu = mdeim.mu_space[Stage.OFFLINE][0]
    with compute_dtype_scope(F64):
        op = getattr(solver, f"assemble_{operator}")(*_mu_t(mu, 1.0))
        want = op.gather(mdeim.rows, mdeim.cols).numpy()
        got = np.asarray(mdeim.interpolate(mu=mu, t=1.0).gather(
            mdeim.rows, mdeim.cols))
        mdeim.evaluate(num=20, ts=tw["ts"])
    assert_allclose(got, want, atol=1e-12 * np.abs(want).max())
    errors = np.concatenate([np.atleast_1d(v) for v in
                             mdeim.errors_rom.values() if np.size(v)])
    assert errors.mean() < 1e-12


@pytest.mark.parametrize("which", ["convection", "diffusion"])
def test_mdeim_ale_moving(which):
    """tests/test_mdeim.py:141-229: the MDEIM of a single ALE term of the
    moving heat solver (the mesh velocity's convection, the scaled
    diffusion) over 10 μ, 2 μ-modes and 2 time modes: its online errors
    under the reference's thresholds (1e-17 convection, 3e-11
    diffusion)."""
    from romtime_tpu_torch.conventions import RomParameters
    from romtime_tpu_torch.deim import MatrixDiscreteEmpiricalInterpolation
    from romtime_tpu_torch.rom.base import Reductor

    class MockSolverALE(HeatEquationMovingSolver):
        def assemble_stiffness(self, mu, t, entries=None):
            w = self.compute_mesh_velocity(mu=mu, t=t)
            alpha = self.create_diffusion_coefficient(mu)
            if which == "diffusion":
                terms = [(1, 1, lambda x: alpha * torch.ones_like(x))]
            else:
                terms = [(1, 0, lambda x: -w(x))]
            return self._assemble_matrix(terms, mu, t, entries)

    domain = dict(L0=2.0, nx=500, nt=250, T=10.0)
    tf = domain["T"]
    omegas = [np.arcsin(1.0 - n) / tf for n in (0.5, 0.8)]
    grid = {"delta": get_uniform_dist(min=0.01, max=5.0),
            "beta": get_uniform_dist(min=0.05, max=0.1),
            "alpha_0": get_uniform_dist(min=0.01, max=2.0),
            "omega": get_uniform_dist(min=min(omegas), max=max(omegas))}
    _, bcs, forcing, u0, ue, Lt, dLt_dt = define_mfp1_problem()
    fom = MockSolverALE(domain=domain, dirichlet=bcs, forcing_term=forcing,
                        u0=u0, Lt=Lt, dLt_dt=dLt_dt, device="cpu")
    fom.setup()
    ts = np.linspace(tf / 250, tf, 250)
    mdeim = MatrixDiscreteEmpiricalInterpolation(
        assemble=fom.assemble_stiffness, name="Stiffness (ALE)", grid=grid,
        tree_walk_params={RomParameters.TS: ts,
                          RomParameters.NUM_SNAPSHOTS: None,
                          RomParameters.NUM_MU: 2, RomParameters.NUM_TIME: 2})
    rnd = np.random.RandomState(0)
    mu_space = list(Reductor(grid=grid).build_sampling_space(num=10,
                                                             rnd=rnd))
    mdeim.setup(rnd=rnd)
    mdeim.run(mu_space=mu_space)
    mdeim.evaluate(ts, mu_space=mu_space)
    summary = mdeim.create_errors_summary()
    assert len(summary["index"]) == 10
    threshold = 1e-17 if which == "convection" else 3e-11
    assert max(summary["mean"]) < threshold, max(summary["mean"])


def test_moving_mock_stiffness():
    """tests/test_mdeim.py:36: the moving mock integrates its stiffness
    on the scaled domain, as the JAX package's."""
    from romtime_tpu.testing import MockSolverMoving as RefMoving
    from romtime_tpu_torch.testing.mock import MockSolverMoving

    _, _bcs, _f, _u0, _ue, Lt, _dLt = define_mfp1_problem()
    from romtime_tpu.problems import define_mfp1_problem as ref_define
    ref_Lt = ref_define()[5]
    port = MockSolverMoving(domain=MOCK_DOMAIN, dirichlet=None, Lt=Lt,
                            device="cpu")
    ref = RefMoving(domain=MOCK_DOMAIN, dirichlet=None, Lt=ref_Lt)
    port.setup()
    ref.setup()
    mu = dict(alpha_0=0.7, omega=0.3)
    with compute_dtype_scope(F64):
        got = port.assemble_stiffness(*_mu_t(mu, 1.3)).todense()
    with ref_dtype_scope(jnp.float64):
        want = np.asarray(ref.assemble_stiffness(
            {k: jnp.float64(v) for k, v in mu.items()},
            jnp.float64(1.3)).todense())
    assert_allclose(got, want, atol=1e-12 * np.abs(want).max())
