"""The port's piston FOM against the JAX package's, on the CPU in float64
(romtime_tpu_torch/fom/base.py, fom/nonlinear.py, base.py, utils/io.py).

Both packages solve the conftest-size piston problem (nx=150, nt=96,
tf=0.6) in both regimes: the reference through its traced loop (its
native f64 loop switched off, ``ROMTIME_NATIVE_FOM=0``), the port through
``solve()`` on the CPU. ``uh``, ``uc``, the nonlinear snapshots and the
probes agree within 1e-12 relative, the bound of
tests/test_native_fom.py:59-62. The behaviour of tests/test_fom_piston.py
(the probe on the piston, mass conservation, ``compute_at``, the
nonlinearity measure, ``save_probes``) is held against the reference's
own functions on the same data, the CSVs written without pandas against
the reference's pandas files.
"""

import copy

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp

from romtime_tpu.fom import OneDimensionalBurgers as RefBurgers
from romtime_tpu.problems import define_piston_problem as ref_problem
from romtime_tpu_torch.convert import fom_from_arrays, piston_fom
from romtime_tpu_torch.dtypes import compute_dtype_scope
from romtime_tpu_torch.fom import OneDimensionalBurgers

jax.config.update("jax_enable_x64", True)

MU = dict(a0=9.3, omega=17.5, delta=0.12, alpha=1e-6, gamma=1.4)
GRID = dict(L=1.0, nx=150, tf=0.6, nt=96)
F64 = torch.float64


def rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(b)


def _reference(which, **options):
    d, bcs, forcing, u0, Lt, dLt = ref_problem(**GRID, which=which)
    ref = RefBurgers(domain=d, dirichlet=bcs, forcing_term=forcing, u0=u0,
                     Lt=Lt, dLt_dt=dLt, **options)
    ref.setup()
    ref.update_parametrization(MU)
    return ref


def _port(which, **options):
    fom = piston_fom(GRID["L"], GRID["nx"], GRID["tf"], GRID["nt"],
                     which=which, device="cpu", **options)
    fom.update_parametrization(MU)
    return fom


@pytest.fixture(scope="module", params=["rest", "sudden"])
def solved(request):
    """(reference, port) after ``solve()``, float64, one regime each."""
    which = request.param
    ref = _reference(which)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ROMTIME_NATIVE_FOM", "0")
        ref.solve()
    port = _port(which)
    with compute_dtype_scope(F64):
        port.solve()
    return which, ref, port


def test_solve_matches_reference(solved):
    _which, ref, port = solved
    got, want = port.solutions, ref.solutions
    assert got.fom.shape == want.fom.shape == (GRID["nx"] + 1, GRID["nt"])
    assert np.isfinite(got.fom).all()
    assert rel(got.snapshots, want.snapshots) < 1e-12
    assert rel(got.fom, want.fom) < 1e-12
    assert rel(got.domain, want.domain) < 1e-14
    assert np.array_equal(got.ts, want.ts)
    assert got.mu == want.mu
    assert rel(np.asarray(port.nonlinear_snapshots),
               np.asarray(ref.nonlinear_snapshots)) < 1e-12
    pr = np.stack([np.asarray(v) for v in port.probes.values()], axis=1)
    pr_ref = np.stack([np.asarray(v) for v in ref.probes.values()], axis=1)
    assert pr.shape == pr_ref.shape == (GRID["nt"], 3)
    assert rel(pr, pr_ref) < 1e-12


def test_topology_and_dirichlet_match_reference(solved):
    """The trilinear snapshot topology (N-MDEIM's layout) and the
    detected Dirichlet entries, equal to the reference's."""
    _which, ref, port = solved
    for a, b in zip(port._nonlinear_topology, ref._nonlinear_topology):
        assert np.array_equal(a, b)
    assert port.entries_dirichlet == ref.entries_dirichlet
    assert port.dofs_dirichlet == ref.dofs_dirichlet
    assert port.dirichlet_dofs == (port.mesh.nh - 1,)
    assert port.build_cell_to_dofs() == ref.build_cell_to_dofs()
    assert port.build_dofs_to_cells() == ref.build_dofs_to_cells()


def test_piston_probe_tracks_dirichlet(solved):
    """The piston probe equals the imposed boundary velocity
    (tests/test_fom_piston.py:54-59). The sudden start carries the
    inconsistent initial value u0 − g0 = δω/a0 on the Dirichlet row,
    which the summed identity rows carry on (a reference quirk,
    tests/test_fom_piston.py:98-103): there the probe is bL plus that
    row's value."""
    which, _ref, port = solved
    ts = port.timesteps
    mach = MU["delta"] * MU["omega"] / MU["a0"]
    if which == "rest":
        want = -mach * np.sin(MU["omega"] * ts)
    else:
        want = (-mach * np.cos(MU["omega"] * ts)
                + port.solutions.snapshots[-1])
    assert np.allclose(np.array(port.probes[2]), want, atol=1e-12)


def test_nonlinear_snapshots_captured(solved):
    which, _ref, port = solved
    snaps = port.nonlinear_snapshots
    assert len(snaps) == GRID["nt"]
    if which == "rest":
        # Zero start: the first snapshot vanishes but for the Dirichlet
        # diagonal (tests/test_fom_piston.py:75-82).
        assert np.allclose(snaps[0][:-1], 0.0)
        assert np.isclose(snaps[0][-1], 1.0)
    assert np.linalg.norm(snaps[-1]) > 0.0


def test_mass_conservation_matches_reference(solved, tmp_path):
    """compute_mass_conservation on the same solutions equals the
    reference's; save_mass_conservation writes the reference's pandas
    CSV (dump_csv) without pandas."""
    _which, ref, port = solved
    sols = port.solutions
    got = port.compute_mass_conservation(mu=MU, ts=sols.ts,
                                         solutions=sols.fom.T, which="fom")
    want = ref.compute_mass_conservation(mu=MU, ts=sols.ts,
                                         solutions=sols.fom.T, which="fom")
    assert list(got) == list(want)
    assert_allclose(got["mass"], want["mass"], rtol=1e-12)
    assert_allclose(got["outflow"], want["outflow"], rtol=1e-12, atol=1e-14)
    # mass_change = d(mass)/dt: the masses' rounding over dt.
    assert_allclose(got["mass_change"], want["mass_change"], rtol=1e-12,
                    atol=1e-13 * np.abs(want["mass"]).max() / port.dt)
    same = copy.copy(port)
    same.solutions = ref.solutions
    path_p, path_r = tmp_path / "port.csv", tmp_path / "ref.csv"
    out = same.save_mass_conservation(str(path_p))
    ref.save_mass_conservation(str(path_r))
    from romtime_tpu.utils import dump_csv as ref_dump_csv

    ref_dump_csv(str(path_r), out)
    assert path_p.read_text() == path_r.read_text()


def test_save_probes_matches_pandas(solved, tmp_path):
    """save_probes writes the reference's pandas table: the same text
    from the same probes, and its own run read back within 1e-12."""
    which, ref, port = solved
    own = port.save_probes(name=str(tmp_path / "own.csv"))
    assert list(own) == [0.0, 0.5, "L"]
    assert np.isfinite(own["L"]).all()
    if which == "rest":
        # Physical units, scaled by a0: the piston moves at δω.
        assert np.abs(own["L"]).max() <= MU["delta"] * MU["omega"] + 1e-9
    df = ref.save_probes(name=str(tmp_path / "ref.csv"))
    back = np.loadtxt(tmp_path / "own.csv", delimiter=",", skiprows=1)
    assert_allclose(back[:, 1:], df.to_numpy(), rtol=1e-12, atol=1e-14)
    assert_allclose(back[:, 0], df.index.to_numpy(), rtol=0, atol=0)
    same = copy.copy(port)
    same.probes, same.solutions = ref.probes, ref.solutions
    same.save_probes(name=str(tmp_path / "same.csv"))
    assert ((tmp_path / "same.csv").read_text()
            == (tmp_path / "ref.csv").read_text())


def test_compute_at_and_nonlinearity(solved):
    """compute_at in physical units (tests/test_fom_piston.py:116-122) and
    the nonlinearity measure, against the reference's."""
    _which, ref, port = solved
    points = port.solutions.compute_at(x=0.0)
    assert points.shape == (GRID["nt"],)
    assert np.allclose(points, port.solutions.fom[0, :] * MU["a0"])
    assert_allclose(points, ref.solutions.compute_at(x=0.0), rtol=1e-12,
                    atol=1e-13)
    assert_allclose(port.solutions.compute_at(x=0.37),
                    ref.solutions.compute_at(x=0.37), rtol=1e-12, atol=1e-13)
    assert np.isclose(port.system_forcing, ref.system_forcing)
    try:
        want = ref.nonlinearity
    except IndexError:
        with pytest.raises(IndexError):
            port.nonlinearity
    else:
        assert_allclose(port.nonlinearity, want, rtol=1e-12)


def test_storage_pickle_and_errors(solved, tmp_path):
    """dump_solutions round trip; evaluate_at and _compute_error against
    the reference's."""
    from romtime_tpu_torch.utils import read_pickle

    _which, ref, port = solved
    port.dump_solutions(str(tmp_path / "sols"))
    back = read_pickle(str(tmp_path / "sols.pkl"))
    assert np.array_equal(back.fom, port.solutions.fom)
    assert back.mu == MU
    u = port.solutions.fom[:, -1]
    ue = ref.solutions.fom[:, -2]
    for norm in ("max", "L2", "H1"):
        assert_allclose(port._compute_error(u, ue, norm),
                        ref._compute_error(u, ue, norm), rtol=1e-12)
    x = np.array([0.0, 0.25, 0.5])
    assert_allclose(port.evaluate_at(u, x).numpy(),
                    np.asarray(ref.evaluate_at(u, x)), rtol=1e-13,
                    atol=1e-15)


def test_isentropic_relations():
    gamma = 1.4
    u = np.linspace(-0.3, 0.3, 7)
    rho = OneDimensionalBurgers.compute_rho(u, gamma)
    p = OneDimensionalBurgers.compute_p(u, gamma)
    assert np.allclose(p, rho ** gamma)
    assert np.isclose(OneDimensionalBurgers.compute_rho(0.0, gamma), 1.0)


# ---------------------------------------------------------------------------
# Full-band operators, the eager system, the initial condition
# ---------------------------------------------------------------------------
def _mu_pair(batch):
    mus = [MU, dict(MU, a0=8.4, omega=19.1, delta=0.105)][:batch or 1]
    if batch:
        port = {k: torch.tensor([m[k] for m in mus], dtype=F64) for k in MU}
    else:
        port = {k: torch.tensor(v, dtype=F64) for k, v in MU.items()}
    return mus, port


@pytest.mark.parametrize("batch", [0, 2])
def test_full_band_operators_match_reference(batch):
    """Every operator over the full band (entries=None) equals the
    reference's for each μ, float64, for one μ (0-d leaves) and for a
    batch of two (the batch trailing)."""
    ref, port = _reference("rest"), _port("rest")
    mus, mu_t = _mu_pair(batch)
    t = torch.tensor(0.21, dtype=F64)
    u = np.random.default_rng(3).normal(size=port.mesh.nh) * 0.05
    for name in ("assemble_mass", "assemble_stiffness", "assemble_convection",
                 "assemble_nonlinear_lifting", "assemble_trilinear",
                 "assemble_nonlinear", "assemble_lifting", "assemble_rhs"):
        kw = ({"u_n": torch.as_tensor(u)} if "trilinear" in name
              or name == "assemble_nonlinear" else {})
        got = getattr(port, name)(mu=mu_t, t=t, **kw)
        got = got.band if hasattr(got, "band") else got
        for j, m in enumerate(mus):
            rkw = {"u_n": jnp.asarray(u)} if kw else {}
            want = getattr(ref, name)(
                mu={k: jnp.asarray(v) for k, v in m.items()},
                t=jnp.asarray(0.21), **rkw)
            want = np.asarray(want.band if hasattr(want, "band") else want)
            lane = got[..., j] if batch else got
            assert_allclose(lane.numpy(), want, rtol=1e-12,
                            atol=1e-13 * np.abs(want).max(), err_msg=name)


def test_eager_assemble_system_records_snapshot():
    """An eager assemble_system records the nonlinear snapshot, as the
    reference's does; the system and its rhs equal the reference's."""
    ref, port = _reference("rest"), _port("rest")
    mu_t = {k: torch.tensor(v, dtype=F64) for k, v in MU.items()}
    mu_j = {k: jnp.asarray(v) for k, v in MU.items()}
    rng = np.random.default_rng(5)
    u_n, u_n1 = (rng.normal(size=port.mesh.nh) * 0.05 for _ in range(2))
    t = torch.tensor(0.3, dtype=F64)
    Mh, Kh = port.assemble_system(mu_t, t, 1.5, torch.as_tensor(u_n),
                                  torch.as_tensor(u_n1))
    Mr, Kr = ref.assemble_system(mu_j, jnp.asarray(0.3), 1.5,
                                 jnp.asarray(u_n), jnp.asarray(u_n1))
    assert_allclose(Kh.todense(), Kr.todense(), rtol=1e-12, atol=1e-12)
    bh = port.assemble_system_rhs(mu_t, t, Mh, torch.as_tensor(u_n),
                                  torch.as_tensor(u_n1))
    br = ref.assemble_system_rhs(mu_j, jnp.asarray(0.3), Mr, jnp.asarray(u_n),
                                 jnp.asarray(u_n1))
    assert_allclose(bh.numpy(), np.asarray(br), rtol=1e-12, atol=1e-15)
    assert len(port.nonlinear_snapshots) == len(ref.nonlinear_snapshots) == 1
    assert_allclose(port.nonlinear_snapshots[0], ref.nonlinear_snapshots[0],
                    rtol=1e-12, atol=1e-14)
    assert_allclose(Kh.data, Kr.data, rtol=1e-12, atol=1e-12)


def test_projected_initial_condition_matches_reference():
    """project_u0: the L2 projection of a non-zero u0 minus the lifting,
    equal to the reference's (a one-lane batch too)."""
    def u0_ref(x, t=0.0, **mu):
        return 0.01 * jnp.sin(np.pi * x)

    def u0_port(x, t=0.0, **mu):
        return 0.01 * torch.sin(np.pi * x)

    ref = _reference("rest", project_u0=True)
    ref.u0 = u0_ref
    port = _port("rest", project_u0=True)
    port.u0 = u0_port
    want = np.asarray(ref._initial_condition(
        {k: jnp.asarray(v) for k, v in MU.items()}))
    got = port._initial_condition(
        {k: torch.tensor(v, dtype=F64) for k, v in MU.items()}).numpy()
    assert np.abs(want).max() > 1e-3
    assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    lanes = port._initial_condition(
        {k: torch.tensor([v], dtype=F64) for k, v in MU.items()}).numpy()
    assert_allclose(lanes[:, 0], want, rtol=1e-12, atol=1e-15)


def test_fom_payload_gives_a_solvable_fom(tmp_path):
    """convert.fom_from_arrays on the payload that tests/torch_parity
    writes (the domain, regime, degree, BDF scheme) and project_u0."""
    from torch_parity import fom_payload

    class _Rom:
        fom = _reference("sudden")

    payload = fom_payload(_Rom, which="sudden")
    fom = fom_from_arrays(payload, device="cpu")
    assert fom.is_setup and fom.device == "cpu"
    assert fom.domain == {"L0": 1.0, "T": 0.6, "nx": 150, "nt": 96}
    assert fom.BDF_SCHEME == "2" and fom.mesh.degree == 1
    assert not fom.project_u0
    assert fom_from_arrays(dict(payload, fom_project_u0=np.bool_(True)),
                           device="cpu").project_u0
    fom.update_parametrization(MU)
    with compute_dtype_scope(F64):
        fom.solve()
    sudden = _port("sudden")
    with compute_dtype_scope(F64):
        sudden.solve()
    assert np.array_equal(fom.solutions.fom, sudden.solutions.fom)


def test_card_entry_points_refuse_without_a_card():
    """Without ``device="cpu"`` the FOM steps on the card: where there is
    none, solve() and solve_fom_batch raise (nothing carries on on the
    CPU)."""
    from romtime_tpu_torch.parallel import solve_fom_batch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    fom = piston_fom(1.0, 20, 0.1, 4)
    fom.update_parametrization(MU)
    assert fom.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        fom.solve()
    with pytest.raises(RuntimeError, match="CUDA"):
        solve_fom_batch(fom, [MU])
    assert fom.solutions is None
