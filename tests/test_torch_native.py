"""The port's native host path (``romtime_tpu_torch/native.py``,
``csrc/host/``, ``fom/native_sweep.py``) against its plain versions.

Anchors: tests/test_native.py (the greedy against numpy, the forbidden
positions, Thomas against a dense solve, the DEIM training through the
native selector) and tests/test_native_fom.py (the native piston loop
against the traced loop in both regimes at 1e-12 relative, ``solve()``
taking it, the refusals, ``ROMTIME_NATIVE_FOM=0``). Here the plain
versions are the port's eager loop and its numpy greedy; the greedy is
also held dof for dof against an independent ``np.argmax`` recursion
(the reference's rule) on bases without near-ties.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from romtime_tpu_torch import native
from romtime_tpu_torch.deim.deim import (
    TIE_RTOL,
    greedy_interpolation_points,
    greedy_numpy,
)
from romtime_tpu_torch.dtypes import compute_dtype_scope
from romtime_tpu_torch.fom.native_sweep import _eligible, outputs_native
from romtime_tpu_torch.fom.nonlinear import OneDimensionalBurgers
from romtime_tpu_torch.problems import define_piston_problem

MU = {"a0": 9.0, "omega": 17.0, "delta": 0.12, "alpha": 1e-6, "gamma": 1.4}
REPO = Path(__file__).resolve().parents[1]


def make_fom(nx=120, nt=150, which="rest", cls=OneDimensionalBurgers, **kw):
    domain, bcs, forcing, u0, Lt, dLt_dt = define_piston_problem(
        L=1.0, nx=nx, tf=1.0, nt=nt, which=which)
    fom = cls(domain=domain, dirichlet=bcs, forcing_term=forcing, u0=u0,
              Lt=Lt, dLt_dt=dLt_dt, device="cpu", **kw)
    fom.setup()
    fom.update_parametrization(MU)
    return fom


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def solve_outputs(fom):
    with compute_dtype_scope(torch.float64):
        fom.solve()
    probes = np.stack([np.asarray(v) for v in fom.probes.values()], axis=1)
    return (np.asarray(fom.solutions.snapshots),
            np.asarray(fom.solutions.fom),
            np.asarray(fom.nonlinear_snapshots), probes)


@pytest.mark.parametrize("which", ["rest", "sudden"])
def test_native_matches_eager_loop(which, monkeypatch):
    """tests/test_native_fom.py:45-67: the native loop's outputs within
    1e-12 relative of the eager loop's, PCR there, Thomas here."""
    fom = make_fom(which=which)
    outs = outputs_native(fom, MU)
    assert outs is not None, "the native path refused an eligible solve"
    assert all(v.dtype == torch.float64 and v.device.type == "cpu"
               for v in outs.values())
    monkeypatch.setenv("ROMTIME_NATIVE_FOM", "0")
    uh, uc, nl, probes = solve_outputs(fom)
    assert rel(outs["uh"].numpy().T, uh) < 1e-12
    assert rel(outs["uc"].numpy().T, uc) < 1e-12
    assert rel(outs["nonlinear_data"].numpy(), nl) < 1e-12
    assert rel(outs["probes"].numpy(), probes) < 1e-12
    assert_allclose(outs["t"].numpy(), fom.solutions.ts, rtol=0, atol=0)
    assert rel(outs["x"].numpy().T, fom.domain_x) < 1e-14


def test_solve_takes_native_and_matches(monkeypatch):
    """tests/test_native_fom.py:70-84: an f64 ``solve()`` goes through
    the native loop (counted) and equals the eager loop at 1e-12."""
    fom = make_fom()
    before = native.calls["piston_fom_solve"]
    got = solve_outputs(fom)
    assert native.calls["piston_fom_solve"] == before + 1
    monkeypatch.setenv("ROMTIME_NATIVE_FOM", "0")
    want = solve_outputs(fom)
    assert native.calls["piston_fom_solve"] == before + 1
    for a, b in zip(got, want):
        assert rel(a, b) < 1e-12


def test_float32_and_dd_keep_the_eager_loop():
    """A float32 solve and a dd sweep never take the native loop."""
    fom = make_fom(nx=40, nt=20)
    before = native.calls["piston_fom_solve"]
    with compute_dtype_scope(torch.float32):
        fom.solve()
    fom.dd_sweep = True
    with compute_dtype_scope(torch.float64):
        fom.solve()
    assert native.calls["piston_fom_solve"] == before


def test_native_refuses_ineligible(monkeypatch):
    """tests/test_native_fom.py:87-111 and the rest of ``_eligible``:
    subclassed physics, BDF-1, degree 2, an exact solution, a projected
    u0, no setup, and ``ROMTIME_NATIVE_FOM=0``."""
    class Tweaked(OneDimensionalBurgers):
        pass

    assert _eligible(make_fom(nx=40, nt=20))
    assert outputs_native(make_fom(nx=40, nt=20, cls=Tweaked), MU) is None
    assert outputs_native(make_fom(nx=40, nt=20, bdf_scheme="1"), MU) is None
    assert outputs_native(make_fom(nx=20, nt=20, degrees=2), MU) is None
    fom = make_fom(nx=40, nt=20)
    fom.exact_solution = lambda x, t, **mu: x
    assert outputs_native(fom, MU) is None
    fom = make_fom(nx=40, nt=20, project_u0=True)
    assert outputs_native(fom, MU) is None
    fom = make_fom(nx=40, nt=20)
    fom.is_setup = False
    assert not _eligible(fom)
    monkeypatch.setenv("ROMTIME_NATIVE_FOM", "0")
    assert outputs_native(make_fom(nx=40, nt=20), MU) is None


def _argmax_greedy(Vf, forbidden=()):
    """An independent greedy with the reference's ``np.argmax`` rule
    (tests/test_native.py:19-39)."""
    Nh, Ns = Vf.shape
    banned = np.zeros(Nh, dtype=bool)
    banned[list(forbidden)] = True

    def argmax(v):
        return int(np.argmax(np.where(banned, -np.inf, np.abs(v).ravel())))

    dofs = [argmax(Vf[:, 0])]
    for j in range(1, Ns):
        coeff = np.linalg.solve(Vf[dofs, :j], Vf[dofs, j])
        dofs.append(argmax(Vf[:, j] - Vf[:, :j] @ coeff))
    return dofs


def _bases():
    rng = np.random.default_rng(0)
    x = np.linspace(0, 1, 200)
    smooth = np.array([np.sin((k + 1) * np.pi * x) / (k + 1)
                       for k in range(8)]).T
    yield "smooth", smooth + 1e-3 * rng.normal(size=smooth.shape), (0, 199)
    yield "random", rng.normal(size=(50, 5)), (0, 1, 2, 49)
    yield "wide", rng.normal(size=(300, 24)), ()


@pytest.mark.parametrize("case", ["smooth", "random", "wide"])
def test_greedy_native_equals_numpy(case):
    """tests/test_native.py:42-60: the native greedy picks the port's
    numpy greedy's dofs, dof for dof, and, on bases without near-ties,
    the reference's (``romtime_tpu.deim.deim``) and an independent
    ``np.argmax`` recursion's; no forbidden position is picked."""
    from romtime_tpu.deim.deim import greedy_interpolation_points as ref

    name, Vf, forbidden = next(b for b in _bases() if b[0] == case)
    got = native.deim_greedy(Vf, forbidden)
    want, _P = greedy_numpy(Vf, forbidden)
    assert got == want
    assert got == _argmax_greedy(Vf, forbidden)
    assert got == [int(d) for d in ref(Vf, list(forbidden))[0]]
    assert not set(got) & set(forbidden)


def test_greedy_ties_take_the_first_position():
    """The stated tie rule, in both: among entries within TIE_RTOL of the
    largest |residual| the first is taken; an exact tie takes the
    reference's first position."""
    Vf = np.zeros((6, 2))
    Vf[:, 0] = [0.5, 1.0, 1.0 * (1 - TIE_RTOL / 4), 0.2, 1.0, 0.1]
    Vf[:, 1] = [1.0, 0.0, 2.0, 3.0 * (1 - TIE_RTOL / 4), 3.0, 0.0]
    got = native.deim_greedy(Vf)
    assert got == greedy_numpy(Vf)[0]
    assert got[0] == 1 and got[0] == _argmax_greedy(Vf)[0]
    exact = np.array([[1.0], [2.0], [-2.0], [2.0]])
    assert native.deim_greedy(exact) == greedy_numpy(exact)[0] == [1]


def test_greedy_entry_builds_P():
    """``greedy_interpolation_points`` returns the native dofs and the
    selection matrix P."""
    _name, Vf, forbidden = next(_bases())
    before = native.calls["deim_greedy"]
    dofs, P = greedy_interpolation_points(Vf, forbidden)
    assert native.calls["deim_greedy"] == before + 1
    assert dofs == greedy_numpy(Vf, forbidden)[0]
    assert_allclose(P.T @ Vf, Vf[dofs], atol=0)


def test_thomas_matches_dense():
    """tests/test_native.py:63-77."""
    rng = np.random.default_rng(2)
    n = 64
    diag = 4.0 + rng.random(n)
    lower, upper = rng.random(n), rng.random(n)
    lower[0] = upper[-1] = 0.0
    rhs = rng.normal(size=n)
    A = np.diag(diag) + np.diag(lower[1:], -1) + np.diag(upper[:-1], 1)
    assert_allclose(native.thomas_solve(lower, diag, upper, rhs),
                    np.linalg.solve(A, rhs), atol=1e-12)


def test_deim_training_uses_native():
    """tests/test_native.py:80-115: the DEIM offline path goes through
    the native selector and interpolates exactly at its training μ."""
    from romtime_tpu_torch.conventions import Stage
    from romtime_tpu_torch.deim import DiscreteEmpiricalInterpolation
    from romtime_tpu_torch.parameters import get_uniform_dist
    from romtime_tpu_torch.testing.mock import MockSolver

    domain = {"L0": 1.0, "nx": 60, "T": 5.0, "nt": 50}

    def forcing(x, t, beta=None, delta=None, alpha_0=None, **mu):
        return beta * torch.exp(-beta * t) * (1.0 + delta * delta * x * x)

    grid = {"delta": get_uniform_dist(min=0.01, max=2.0),
            "beta": get_uniform_dist(min=1.0, max=10.0),
            "alpha_0": get_uniform_dist(min=0.01, max=2.0)}
    solver = MockSolver(domain=domain, dirichlet=None, forcing_term=forcing,
                        device="cpu")
    solver.setup()
    deim = DiscreteEmpiricalInterpolation(
        name="forcing", assemble=solver.assemble_forcing,
        tree_walk_params={"ts": np.linspace(0, 5, 10), "num_snapshots": 10},
        grid=grid)
    deim.setup(rnd=np.random.RandomState(0))
    before = native.calls["deim_greedy"]
    deim.run()
    assert native.calls["deim_greedy"] == before + 1
    mu = deim.mu_space[Stage.OFFLINE][0]
    with compute_dtype_scope(torch.float64):
        expected = solver.assemble_forcing(
            mu={k: torch.tensor(float(v), dtype=torch.float64)
                for k, v in mu.items()},
            t=torch.tensor(1.0, dtype=torch.float64)).numpy()
        approx = deim._interpolate(mu=mu, t=1.0)
    assert_allclose(expected, approx, atol=1e-14)


def _tree(path):
    return {p: p.stat().st_mtime_ns for p in sorted(Path(path).rglob("*"))}


def test_library_builds_under_build_native_and_csrc_untouched():
    """The library lives in build/native/ at the root of the checkout,
    is rebuilt only from the port's own sources, and no build writes
    into csrc/ (the reference's) or the port's csrc/."""
    csrc, port_csrc = REPO / "csrc", REPO / "romtime_tpu_torch" / "csrc"
    before = (_tree(csrc), _tree(port_csrc))
    path = native.build()
    native.load()
    assert path == REPO / "build" / "native" / "libromtime_native.so"
    assert path.exists()
    assert all(src.parent == port_csrc / "host" for src in native.SOURCES)
    assert (_tree(csrc), _tree(port_csrc)) == before


def test_failed_build_raises_with_the_log(tmp_path, monkeypatch):
    """A source g++ refuses: the build raises with the compiler's log
    and leaves no library behind."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "SOURCES", (bad,))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(native, "LIBRARY", tmp_path / "out" / "lib.so")
    with pytest.raises(RuntimeError, match="native build failed") as err:
        native.build()
    assert "error" in str(err.value)
    assert not (tmp_path / "out" / "lib.so").exists()
    assert not [p for p in os.listdir(tmp_path / "out") if p.endswith(".so")]
