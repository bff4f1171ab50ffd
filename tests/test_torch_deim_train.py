"""The port's DEIM training (romtime_tpu_torch/deim/deim.py, mdeim.py,
nonlinear.py) against the JAX package's, on the piston FOM of both
packages (nx=100, nt=50, 3 μ of the piston box from the seeded sampler),
in float64, the reference's SVD routed through numpy
(tests/torch_parity.py:22-24).

Anchors: tests/test_deim.py (tree walk, interpolation at a training and
an unseen μ, the error sweep and its summary, the batch, copy and
persistence, the weighted tree walk), tests/test_mdeim.py (the tree
walk and the ROM projection) and tests/test_nmdeim.py (run, interpolate,
linearity in the state, truncate, the projection's shape, evaluate); their
heat ``MockSolver`` cases wait for the heat path (ROADMAP Queue 1, item
10). The greedy: the port's dofs equal the reference's
``greedy_interpolation_points`` in order on seeded bases, with and
without ``forbidden``.

Limits: σ within 1e-10 relative; the interpolants of the two packages
within 1e-12 relative at a training and at an unseen μ; at a training
μ the interpolant reproduces the assembly to 1e-12 relative for the
operator families of exact low rank (mass, stiffness, convection,
nonlinear lifting) and to 1e-10 for the RHS, whose third σ (3e-11 of σ₁)
falls under the drop floor in both packages. Dofs: equal, in order;
where the two differ, either as the same set (the collateral spectrum
degenerate, σ₁ = σ₂ to rounding, so the SVD's basis of that plane is
any rotation of it and the greedy's order follows the rotation), as
the port's tie rule applied to the reference's own basis (a greedy step
tied up to rounding: ``deim.deim.TIE_RTOL``), or, where every kept σ is
the same (the N-MDEIM's normalized stacks: σ = √3 three times), as
another valid selection of the same span (projectors within 1e-10).
The S-variant and the projection are compared on one collateral basis,
the reference's, adopted by the port (``load_fom_basis``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romtime_tpu.deim import DiscreteEmpiricalInterpolation as RefDEIM
from romtime_tpu.deim import MatrixDiscreteEmpiricalInterpolation as RefMDEIM
from romtime_tpu.deim import deim as ref_deim_module
from romtime_tpu.deim.nonlinear import (
    MatrixDiscreteEmpiricalInterpolationNonlinear as RefNMDEIM,
)
from romtime_tpu.fom import OneDimensionalBurgers as RefBurgers
from romtime_tpu.parameters import ParameterSampler as RefSampler
from romtime_tpu.parameters import get_uniform_dist as ref_uniform
from romtime_tpu.problems import define_piston_problem as ref_problem
from romtime_tpu.utils import read_pickle as ref_read_pickle
from romtime_tpu_torch.conventions import RomParameters, Stage
from romtime_tpu_torch.convert import piston_fom
from romtime_tpu_torch.deim import (
    DiscreteEmpiricalInterpolation,
    MatrixDiscreteEmpiricalInterpolation,
    MatrixDiscreteEmpiricalInterpolationNonlinear,
)
from romtime_tpu_torch.deim.deim import greedy_interpolation_points
from romtime_tpu_torch.dtypes import compute_dtype_scope
from romtime_tpu_torch.parameters import get_uniform_dist
from romtime_tpu_torch.utils import read_pickle
from torch_parity import _numpy_svd

jax.config.update("jax_enable_x64", True)

GRID = dict(L=1.0, nx=100, tf=1.0, nt=50)
TS = np.linspace(0.02, 1.0, 50)
BOX = dict(a0=(8.0, 10.0), omega=(15.0, 20.0), delta=(0.1, 0.15),
           alpha=(1e-6, 1e-6), gamma=(1.4, 1.4))
#: operator → (port class, reference class, assembly method).
OPERATORS = {
    "rhs": (DiscreteEmpiricalInterpolation, RefDEIM, "assemble_rhs"),
    "mass": (MatrixDiscreteEmpiricalInterpolation, RefMDEIM,
             "assemble_mass"),
    "stiffness": (MatrixDiscreteEmpiricalInterpolation, RefMDEIM,
                  "assemble_stiffness"),
    "convection": (MatrixDiscreteEmpiricalInterpolation, RefMDEIM,
                   "assemble_convection"),
    "nonlinear-lifting": (MatrixDiscreteEmpiricalInterpolation, RefMDEIM,
                          "assemble_nonlinear_lifting"),
}
#: Training μ reproduced to 1e-12 relative, but the RHS (see the doc).
TRAIN_LIMIT = {"rhs": 1e-10}


@pytest.fixture(autouse=True)
def numpy_svd(monkeypatch):
    monkeypatch.setattr(jnp.linalg, "svd", _numpy_svd)


@pytest.fixture(scope="module")
def foms():
    d, bcs, forcing, u0, Lt, dLt = ref_problem(**GRID)
    ref = RefBurgers(domain=d, dirichlet=bcs, forcing_term=forcing, u0=u0,
                     Lt=Lt, dLt_dt=dLt)
    ref.setup()
    return piston_fom(GRID["L"], GRID["nx"], GRID["tf"], GRID["nt"],
                      device="cpu"), ref


def _grids():
    return ({k: get_uniform_dist(lo, hi) for k, (lo, hi) in BOX.items()},
            {k: ref_uniform(lo, hi) for k, (lo, hi) in BOX.items()})


def _unseen():
    return list(RefSampler(_grids()[1], 1, np.random.RandomState(19219)))[0]


def _ref_dofs(red):
    return [tuple(int(v) for v in e) for e in red.dofs]


def _positions(red):
    """The port reductor's dofs as positions of its vector form."""
    if red.ENTRY_WIDTH == 1:
        return [d[0] for d in red.dofs]
    index = {(int(r), int(c)): i for i, (r, c) in
             enumerate(zip(red.rows, red.cols))}
    return [index[d] for d in red.dofs]


def assert_same_dofs(port, ref):
    """Equal in order; else the same set, the port's tie rule on the
    reference's own basis giving the port's picks, or a degenerate
    collateral spectrum spanning the same space (see the module doc)."""
    got, want = list(port.dofs), _ref_dofs(ref)
    if got == want or sorted(got) == sorted(want):
        return
    picks, _P = greedy_interpolation_points(
        np.asarray(ref.basis_fom), port._forbidden_greedy_positions())
    if picks == _positions(port):
        return
    s = np.asarray(ref.sigmas)[: ref.N]
    assert s.max() - s.min() <= 1e-8 * s.max(), (got, want)
    U, Ur = port.basis_fom, np.asarray(ref.basis_fom)
    np.testing.assert_allclose(U @ U.T, Ur @ Ur.T, rtol=0, atol=1e-10)


def _train(foms, op, params, mu_space=None):
    port_cls, ref_cls, method = OPERATORS[op]
    fom, ref_fom = foms
    grid, ref_grid = _grids()
    port = port_cls(assemble=getattr(fom, method), grid=grid,
                    tree_walk_params=params, name=op)
    ref = ref_cls(assemble=getattr(ref_fom, method), grid=ref_grid,
                  tree_walk_params=params, name=op)
    for red in (port, ref):
        red.setup(rnd=np.random.RandomState(0))
        red.run(mu_space=mu_space)
    return port, ref


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(np.abs(np.asarray(b)).max(), 1e-300))


def test_greedy_matches_reference():
    """The selection on seeded bases, in order, with and without the
    forbidden positions (romtime_tpu/deim/deim.py:38-88)."""
    rng = np.random.default_rng(0)
    for trial in range(4):
        Vf = np.linalg.qr(rng.normal(size=(80, 6 + 3 * trial)))[0]
        for forbidden in (None, [0, 79], list(range(0, 80, 7))):
            got, P = greedy_interpolation_points(Vf, forbidden)
            want, P_ref = ref_deim_module.greedy_interpolation_points(
                Vf, forbidden)
            assert got == [int(d) for d in want]
            np.testing.assert_array_equal(P, np.asarray(P_ref))
            assert not set(got) & set(forbidden or ())


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["normalized", "weighted"])
@pytest.mark.parametrize("op", list(OPERATORS))
def test_tree_walk_matches_reference(foms, op, weighted):
    """tests/test_deim.py::test_deim_tree_walk and
    tests/test_mdeim.py::test_mdeim_tree_walk on the piston operators:
    the same offline μ, dofs and σ, the interpolants at a training and an
    unseen μ, the training μ reproduced; ``weighted_pod``
    (tests/test_deim.py::test_deim_weighted_tree_walk) keeps the
    σ-weighted stacks unnormalized."""
    params = {RomParameters.TS: TS, RomParameters.NUM_SNAPSHOTS: 3}
    if weighted:
        params[RomParameters.WEIGHTED_POD] = True
    port, ref = _train(foms, op, params)
    assert port.mu_space[Stage.OFFLINE] == ref.mu_space[Stage.OFFLINE]
    assert port.N == ref.N and port.basis_fom.shape == ref.basis_fom.shape
    sr = np.asarray(ref.sigmas)
    np.testing.assert_allclose(port.sigmas[: port.N], sr[: port.N], rtol=0,
                               atol=1e-10 * sr[0])
    assert_same_dofs(port, ref)
    assert port.report[Stage.OFFLINE][port.BASIS_FINAL] == port.N

    mu = port.mu_space[Stage.OFFLINE][1]
    unseen = _unseen()
    with compute_dtype_scope(torch.float64):
        got = port._interpolate(mu=mu, t=TS[7])
        truth = port.assemble_snapshot(mu, TS[7])
        got_unseen = port._interpolate(mu=unseen, t=0.55)
    assert _rel(got, ref._interpolate(mu=mu, t=TS[7])) <= 1e-12
    assert _rel(got_unseen, ref._interpolate(mu=unseen, t=0.55)) <= 1e-12
    assert _rel(got, truth) <= TRAIN_LIMIT.get(op, 1e-12)


def test_deim_batch_evaluate_and_summary(foms):
    """tests/test_deim.py::test_deim_batch_matches_serial and the error
    sweep: the time grid in one call equals the per-t assembly, and the
    online errors and their summary match the reference's."""
    params = {RomParameters.TS: TS, RomParameters.NUM_SNAPSHOTS: 3}
    port, ref = _train(foms, "rhs", params)
    mu = _unseen()
    ts = np.linspace(0.1, 1.0, 7)
    with compute_dtype_scope(torch.float64):
        batch = port.assemble_snapshots_batch(mu, ts)
        for i, t in enumerate(ts):
            np.testing.assert_allclose(batch[:, i],
                                       port.assemble_snapshot(mu, t),
                                       rtol=0, atol=1e-15)
        interp = port.interpolate_batch(mu, ts)
    np.testing.assert_allclose(
        interp, np.asarray(ref.interpolate_batch(mu, ts)), rtol=0,
        atol=1e-12 * np.abs(interp).max())
    space = list(RefSampler(_grids()[1], 4, np.random.RandomState(2)))
    port.evaluate(ts=TS[::5], mu_space=space)
    ref.evaluate(ts=TS[::5], mu_space=space)
    for idx, err in ref.errors_rom.items():
        np.testing.assert_allclose(port.errors_rom[idx], np.asarray(err),
                                   rtol=1e-6, atol=1e-16)
    summary = port.create_errors_summary()
    ref.create_errors_summary()
    np.testing.assert_allclose(summary["max"],
                               ref.summary_errors["max"].to_numpy(),
                               rtol=1e-6, atol=1e-16)


@pytest.mark.parametrize("op", ["rhs", "convection"])
def test_copy_persistence_and_projection(foms, op, tmp_path, monkeypatch):
    """tests/test_deim.py::test_deim_copy_and_persistence and
    tests/test_mdeim.py::test_mdeim_rom_projection: ``copy`` carries the
    trained state; the collateral basis pickled by either package, a
    numpy array under the reference's name, rebuilds the same
    interpolation in the other; ``project_basis`` against the
    reference's (Vᵀ·Vf, or Vᵀ·A_i·V per mode) and the ROM interpolant."""
    monkeypatch.chdir(tmp_path)
    params = {RomParameters.TS: TS, RomParameters.NUM_SNAPSHOTS: 3}
    port, ref = _train(foms, op, params)
    other = port.copy()
    np.testing.assert_array_equal(other.basis_fom, port.basis_fom)
    assert other.dofs == port.dofs and other.dofs is not port.dofs
    np.testing.assert_array_equal(other.PT_U, port.PT_U)

    name = port.basis_pickle_name
    assert name == ref.basis_pickle_name
    mu = _unseen()
    for dumper, loader in ((port, ref), (ref, port)):
        dumper.dump_fom_basis()
        assert isinstance(read_pickle(name), np.ndarray)
        fresh = loader.copy()
        fresh.load_fom_basis()
        np.testing.assert_array_equal(np.asarray(fresh.basis_fom),
                                      np.asarray(ref_read_pickle(name)))
        with compute_dtype_scope(torch.float64):
            got = np.asarray(fresh._interpolate(mu=mu, t=0.3))
            want = np.asarray(dumper._interpolate(mu=mu, t=0.3))
        assert _rel(got, want) <= 1e-12

    V = np.linalg.qr(np.random.default_rng(0).normal(
        size=(foms[0].mesh.nh, 5)))[0]
    port.project_basis(V)
    ref.project_basis(V)
    n_out = 5 if op == "rhs" else 25
    assert port.basis_rom.shape == (n_out, port.N) == ref.basis_rom.shape
    # The projection of one collateral basis (the reference's: a
    # degenerate spectrum leaves each package its own rotation of it).
    twin = port.copy()
    twin.basis_fom = np.asarray(ref.basis_fom)
    twin.project_basis(V)
    np.testing.assert_allclose(twin.basis_rom, np.asarray(ref.basis_rom),
                               rtol=0, atol=1e-12 * np.abs(
                                   twin.basis_rom).max())
    with compute_dtype_scope(torch.float64):
        got = port.interpolate(mu=mu, t=0.3, which=port.ROM)
    want = ref.interpolate(mu=mu, t=0.3, which=ref.ROM)
    assert np.asarray(got).shape == np.asarray(want).shape
    assert _rel(got, want) <= 1e-12
    if op == "convection":
        with compute_dtype_scope(torch.float64):
            op_fom = port.interpolate(mu=mu, t=0.3)
        np.testing.assert_allclose(op_fom.todense(), np.asarray(
            ref.interpolate(mu=mu, t=0.3).todense()), rtol=0,
            atol=1e-12 * np.abs(op_fom.todense()).max())


@pytest.fixture(scope="module")
def psi_pair(foms):
    """The N-MDEIM trained by both packages on a smooth ψ basis
    (tests/test_nmdeim.py:42-46)."""
    fom, ref_fom = foms
    x = np.asarray(fom.mesh.x_dofs)
    psi = np.array([np.sin((k + 1) * np.pi * x) * 0.1 for k in range(3)]).T
    params = {RomParameters.TS: np.linspace(0.1, 1.0, 10),
              RomParameters.NUM_SNAPSHOTS: 3}
    grid, ref_grid = _grids()
    port = MatrixDiscreteEmpiricalInterpolationNonlinear(
        name="trilinear", assemble=fom.assemble_trilinear, grid=grid,
        tree_walk_params=params)
    ref = RefNMDEIM(name="trilinear", assemble=ref_fom.assemble_trilinear,
                    grid=ref_grid, tree_walk_params=params)
    jax.config.update("jax_enable_x64", True)
    for red in (port, ref):
        red.setup(rnd=np.random.RandomState(0))
        red.run(u_n=psi)
    return port, ref, psi


def test_nmdeim_run_and_interpolate(psi_pair):
    """tests/test_nmdeim.py::test_nmdeim_run_and_interpolate: the same
    topology, dofs and σ; at a trained μ and ψ, and on a combination of
    the ψ (linearity in the state), the interpolant within 1e-8·max(scale,
    1) of the assembly and within 1e-12 relative of the reference's."""
    port, ref, psi = psi_pair
    np.testing.assert_array_equal(port.rows, np.asarray(ref.rows))
    np.testing.assert_array_equal(port.cols, np.asarray(ref.cols))
    assert port.N == ref.N > 0
    sr = np.asarray(ref.sigmas)
    np.testing.assert_allclose(port.sigmas[: port.N], sr[: port.N], rtol=0,
                               atol=1e-10 * sr[0])
    assert_same_dofs(port, ref)
    mu = port.mu_space[Stage.OFFLINE][0]
    for state in (psi[:, 0], 0.5 * psi[:, 0] + 0.25 * psi[:, 1]):
        with compute_dtype_scope(torch.float64):
            truth = port.assemble_snapshot(mu, 0.5, u_n=state)
            appr = port.interpolate(mu=mu, t=0.5, u_n=state).gather(
                port.rows, port.cols).numpy()
        scale = np.abs(truth).max()
        assert np.abs(truth - appr).max() < 1e-8 * max(scale, 1.0)
        want = np.asarray(ref.interpolate(mu=mu, t=0.5, u_n=state).gather(
            ref.rows, ref.cols))
        assert _rel(appr, want) <= 1e-12


def test_nmdeim_truncate_projection_and_evaluate(psi_pair):
    """tests/test_nmdeim.py::test_nmdeim_truncate and
    ::test_nmdeim_projection_shape on the reference's collateral basis
    adopted by the port: the "S-" variant shares the topology, picks the
    reference's dofs and still interpolates; the projection and the ROM
    interpolant against the reference's; the (μ, t, ψ) error sweep finite
    and at the rounding level of the reference's (ψ in the trained span)."""
    port, ref, psi = psi_pair
    twin = port.copy()
    twin.u_n = port.u_n
    twin.load_fom_basis(basis=np.asarray(ref.basis_fom))
    assert_same_dofs(twin, ref)
    N = twin.N
    truncated = twin.truncate(n=1)
    ref_truncated = ref.truncate(n=1)
    assert truncated.N == N - 1 and truncated.name == "S-trilinear"
    assert truncated.rows is twin.rows
    assert_same_dofs(truncated, ref_truncated)
    mu = port.mu_space[Stage.OFFLINE][0]
    with compute_dtype_scope(torch.float64):
        op = truncated.interpolate(mu=mu, t=0.5, u_n=psi[:, 0])
    assert op.todense().shape == (port.solver.mesh.nh,) * 2

    V = np.linalg.qr(np.random.default_rng(0).normal(
        size=(port.solver.mesh.nh, 4)))[0]
    twin.project_basis(V)
    ref.project_basis(V)
    assert twin.basis_rom.shape == (16, N) == ref.basis_rom.shape
    np.testing.assert_allclose(twin.basis_rom, np.asarray(ref.basis_rom),
                               rtol=0, atol=1e-12 * np.abs(
                                   twin.basis_rom).max())
    with compute_dtype_scope(torch.float64):
        AN = twin.interpolate(mu=mu, t=0.5, u_n=psi[:, 0], which=twin.ROM)
    assert AN.shape == (4, 4)
    assert _rel(AN, ref.interpolate(mu=mu, t=0.5, u_n=psi[:, 0],
                                    which=ref.ROM)) <= 1e-12
    ts = np.linspace(0.1, 1.0, 6)
    space = port.mu_space[Stage.OFFLINE]
    port.evaluate(ts=ts, mu_space=space)
    ref.evaluate(ts=ts, mu_space=space)
    with compute_dtype_scope(torch.float64):
        scale = np.abs(port.assemble_snapshot(mu, 0.5, u_n=psi[:, 0])).max()
    for idx, err in ref.errors_rom.items():
        got = port.errors_rom[idx]
        assert got.shape == np.asarray(err).shape
        assert np.isfinite(got).all()
        assert got.max() <= 1e-12 * scale
        assert np.asarray(err).max() <= 1e-12 * scale
