"""The port's MFP1 heat FOM (romtime_tpu_torch/fom/heat.py,
problems/mfp1.py) against the JAX package and the pinned goldens.

- The FOM: the golden operators and the golden exact-solution errors
  (tests/test_fom_heat.py:46-124), the convergence goldens at nt 10 and
  100 (tests/test_convergence_goldens.py; nt=1000 is held on the card),
  the fixed, moving, BDF-2, P3 and dd loops against the JAX package's at
  1e-12 (tests/test_fom_dd.py:26-80, tests/test_higher_degree.py:56-78).

The heat ROM is held in tests/test_torch_heat_rom.py, the mock (M)DEIM
trainings in tests/test_torch_heat_deim.py.
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_almost_equal

from romtime_tpu.dtypes import compute_dtype_scope as ref_dtype_scope
from romtime_tpu_torch.dtypes import compute_dtype_scope
from romtime_tpu_torch.fom import HeatEquationMovingSolver, HeatEquationSolver
from romtime_tpu_torch.parameters import ParameterSampler, get_uniform_dist
from romtime_tpu_torch.problems import define_mfp1_problem

jax.config.update("jax_enable_x64", True)

F64 = torch.float64
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
BOX = {"delta": (0.01, 2.0), "beta": (1.0, 10.0), "alpha_0": (0.01, 2.0)}


def port_grid():
    return {k: get_uniform_dist(min=lo, max=hi) for k, (lo, hi) in BOX.items()}


def ref_grid():
    from romtime_tpu.parameters import get_uniform_dist as ref_uniform

    return {k: ref_uniform(min=lo, max=hi) for k, (lo, hi) in BOX.items()}


def tensors(mu):
    return {k: torch.tensor(float(v), dtype=F64) for k, v in mu.items()}


def _mu_t(mu, t):
    return tensors(mu), torch.tensor(float(t), dtype=F64)


def port_solver(L, nx, nt, tf, mu=None, moving=False, **kw):
    domain, bcs, forcing, u0, ue, Lt, dLt_dt = define_mfp1_problem(L, nx,
                                                                   tf, nt)
    extra = dict(Lt=Lt, dLt_dt=dLt_dt) if moving else {}
    cls = HeatEquationMovingSolver if moving else HeatEquationSolver
    s = cls(domain=domain, dirichlet=bcs, parameters=mu, forcing_term=forcing,
            u0=u0, exact_solution=ue, device="cpu", **extra, **kw)
    s.setup()
    return s


def ref_solver(L, nx, nt, tf, mu=None, moving=False, **kw):
    from romtime_tpu.fom import heat
    from romtime_tpu.problems import define_mfp1_problem as ref_define

    domain, bcs, forcing, u0, ue, Lt, dLt_dt = ref_define(L, nx, tf, nt)
    extra = dict(Lt=Lt, dLt_dt=dLt_dt) if moving else {}
    cls = heat.HeatEquationMovingSolver if moving else heat.HeatEquationSolver
    s = cls(domain=domain, dirichlet=bcs, parameters=mu, forcing_term=forcing,
            u0=u0, exact_solution=ue, **extra, **kw)
    s.setup()
    return s


def log10_error_tf(s):
    return float(np.log10(s.errors[s.timesteps[-1]]))


# ---------------------------------------------------------------------------
# The FOM
# ---------------------------------------------------------------------------
def test_golden_operators():
    """tests/test_fom_heat.py:46-100: Ah, Mh, fh, fgh on a 3-cell mesh
    for three sampled μ (the reference's dofs run L→0: vectors flipped)."""
    solver = port_solver(2.0, 3, 500, 10.0)
    sampler = ParameterSampler(port_grid(), n_iter=3,
                               random_state=np.random.RandomState(0))
    Ah, Mh, fh, fgh = [], [], [], []
    t0 = torch.tensor(0.0, dtype=F64)
    for sample in sampler:
        mu = tensors(sample)
        Ah.append(solver.assemble_stiffness(mu=mu, t=t0).todense().ravel())
        Mh.append(solver.assemble_mass(mu=mu, t=t0).todense().ravel())
        fh.append(np.flip(solver.assemble_forcing(mu=mu, t=t0).numpy()))
        fgh.append(np.flip(solver.assemble_lifting(mu=mu, t=t0).numpy()))
    ah = [-1.65320831, -1.6414763, -1.32119783]
    expected_Ah = np.array([[1.0, 0.0, 0.0, 0.0, a, -2 * a, a, 0.0, 0.0, a,
                             -2 * a, a, 0.0, 0.0, 0.0, 1.0] for a in ah])
    expected_Mh = np.array(
        [[1.0, 0.0, 0.0, 0.0, 0.11111111, 0.44444444, 0.11111111, 0.0,
          0.0, 0.11111111, 0.44444444, 0.11111111, 0.0, 0.0, 0.0, 1.0]] * 3)
    expected_fh = np.array([[0.0, 18.38874897, 8.71846778, 0.0],
                            [0.0, 13.17828361, 6.00010814, 0.0],
                            [0.0, 47.42510228, 17.611488, 0.0]])
    expected_fgh = np.array([[0.0, -24.29836526, -14.62808406, 0.0],
                             [0.0, -17.56494639, -10.38677093, 0.0],
                             [0.0, -65.64453323, -35.83091895, 0.0]])
    assert_array_almost_equal(expected_Ah, np.array(Ah))
    assert_array_almost_equal(expected_Mh, np.array(Mh))
    assert_array_almost_equal(expected_fh, np.array(fh))
    assert_array_almost_equal(expected_fgh, np.array(fgh))


def test_golden_errors():
    """tests/test_fom_heat.py:103-124: log10 errors at t=tf, nx=500,
    nt=10, for three sampled μ. The trajectories equal the JAX package's
    within 1e-12 relative; the log10 errors (~1e-5.5, so a 1e-13
    relative difference in u moves them by ~1e-7) within 1e-6 of the
    pinned values, the spread the reference's own note gives for a
    solver with another rounding order (7e-7, test_fom_heat.py:112-113)."""
    from romtime_tpu.parameters import ParameterSampler as RefSampler

    solver = port_solver(2.0, 500, 10, 10.0)
    ref = ref_solver(2.0, 500, 10, 10.0)
    got = []
    for sample in RefSampler(ref_grid(), n_iter=3,
                             random_state=np.random.RandomState(0)):
        solver.update_parametrization(sample)
        ref.update_parametrization(sample)
        with compute_dtype_scope(F64):
            solver.solve()
        with ref_dtype_scope(jnp.float64):
            ref.solve()
        want = np.asarray(ref.solutions.fom)
        assert (np.linalg.norm(solver.solutions.fom - want)
                / np.linalg.norm(want)) < 1e-12
        got.append(log10_error_tf(solver))
    assert_allclose(
        got, [-5.527061428322073, -5.451463969073607, -4.431683868240552],
        rtol=0, atol=1e-6)


def _golden(moving):
    name = f"mfp1_convergence_{'moving' if moving else 'fixed'}.csv"
    with open(os.path.join(GOLDENS, name)) as fh:
        return {int(r["nt"]): float(r["log10_error"])
                for r in csv.DictReader(fh)}


@pytest.mark.parametrize("nt", [10, 100])
@pytest.mark.parametrize("moving", [False, True], ids=["fixed", "moving"])
def test_convergence_goldens(moving, nt):
    """tests/test_convergence_goldens.py (nx=500, tf to 99% decay): the
    port's log10 error at t=tf within 1e-8 of the JAX package's, and as
    close to the pinned study as the JAX package's own (which sits up to
    2.1e-6 from it: that slow-tier test holds 1e-7)."""
    beta = 5.0
    tf = -np.log(1.0 - 0.99) / beta
    mu = dict(delta=1.0, beta=beta, alpha_0=1.0)
    if moving:
        mu["omega"] = 2.0 * np.pi / (8.0 * tf)
    solver = port_solver(2.0, 500, nt, tf, mu=mu, moving=moving)
    ref = ref_solver(2.0, 500, nt, tf, mu=mu, moving=moving)
    with compute_dtype_scope(F64):
        solver.solve()
    with ref_dtype_scope(jnp.float64):
        ref.solve()
    got, want = log10_error_tf(solver), log10_error_tf(ref)
    golden = _golden(moving)[nt]
    assert abs(got - want) <= 1e-8
    assert abs(got - golden) <= abs(want - golden) + 1e-8


FOM_CASES = {
    "fixed": dict(moving=False),
    "moving": dict(moving=True),
    "bdf2": dict(moving=False, bdf2=True),
    "p3": dict(moving=False, degrees=3),
    "dd": dict(moving=False, dd=True),
}


@pytest.mark.parametrize("case", sorted(FOM_CASES))
def test_fom_matches_reference(case):
    """The port's loops against the JAX package's in float64 (plain, the
    moving ALE loop, BDF-2, P3, the dd residual loop): the trajectory and
    the exact-solution errors within 1e-12 relative
    (tests/test_fom_dd.py:26-80, tests/test_higher_degree.py:56-78)."""
    opts = dict(FOM_CASES[case])
    moving, dd = opts.pop("moving"), opts.pop("dd", False)
    bdf2 = opts.pop("bdf2", False)
    mu = dict(delta=0.5, beta=3.0, alpha_0=0.7)
    if moving:
        mu["omega"] = np.arcsin(0.5) / 10.0
    nx = 20 if opts.get("degrees") == 3 else 80
    port = port_solver(2.0, nx, 50, 10.0, mu=mu, moving=moving,
                       bdf_scheme="2" if bdf2 else None, **opts)
    ref = ref_solver(2.0, nx, 50, 10.0, mu=mu, moving=moving, **opts)
    if bdf2:
        ref.BDF_SCHEME = "2"
    port.dd_sweep = ref.dd_sweep = dd
    with compute_dtype_scope(F64):
        port.solve()
    with ref_dtype_scope(jnp.float64):
        ref.solve()
    want = np.asarray(ref.solutions.fom)
    got = port.solutions.fom
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-12
    e_ref = np.array([ref.errors[t] for t in ref.timesteps])
    e_port = np.array([port.errors[t] for t in port.timesteps])
    assert np.abs(e_port - e_ref).max() <= 1e-10 * np.abs(e_ref).max()
