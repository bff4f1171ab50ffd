"""The port's library auxiliaries against the JAX package's, on the CPU:
the typed configuration (romtime_tpu_torch/config.py), the model
registry (models/__init__.py), the numeric helpers (utils/numeric.py,
tests/test_utils.py's cases), the phase timer, the timing helper, the
profiler trace and the progress reporter (utils/profiling.py,
utils/progress.py), the plots (utils/plotting.py and the plot methods of
the FOM, the (M)DEIM reductors and the legacy MFP1 drivers; each writes
its file under the Agg backend, skipped without matplotlib), and the
small FOM API (``x``, ``L``, ``move_mesh``, ``runtime_process``,
``find_cells_to_cover``, ``create_algebraic_solver``, ``dict_to_array``)
on the MFP1 and piston solvers. Limits: equal, or 1e-12 relative where
floating point enters.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import romtime_tpu.config as ref_config
import romtime_tpu.models as ref_models
import romtime_tpu.utils.numeric as ref_numeric
import romtime_tpu_torch.config as config
import romtime_tpu_torch.models as models
from romtime_tpu.fom import OneDimensionalBurgers as RefBurgers
from romtime_tpu.problems import define_piston_problem as ref_piston
from romtime_tpu_torch.dtypes import compute_dtype_scope
from romtime_tpu_torch.fom import OneDimensionalBurgers
from romtime_tpu_torch.problems import define_piston_problem
from romtime_tpu_torch.utils import (
    PhaseTimer,
    block_and_time,
    compute_rom_difference,
    eliminate_zeros_vector,
    progress,
    project_dense,
    singular_to_energy,
    singular_to_pod_error,
    time_average,
    torch_trace,
)
from test_torch_heat import port_solver, ref_solver

HEAT = dict(L=2.0, nx=20, nt=10, tf=1.0)
HEAT_MU = dict(delta=0.5, beta=3.0, alpha_0=0.7)
PISTON = dict(L=1.0, nx=16, tf=0.1, nt=4)
PISTON_MU = dict(a0=9.0, omega=17.0, delta=0.12, alpha=1e-6, gamma=1.4)


# ----------------------------------------------------------------------
# config.py
# ----------------------------------------------------------------------
def _configs(mod):
    domain = mod.DomainConfig(L0=1.0, T=0.6, nx=150, nt=96)
    fom = mod.FomConfig(domain=domain, dirichlet={"bL": 0.0},
                        grid_params={"a0": "uniform"}, Lt=len, dLt_dt=abs)
    rom = mod.RomConfig(num_snapshots=3, srom_truncate=2, nmdeim_size=10)
    walk = mod.TreeWalkConfig(ts=[0.1, 0.2], num_snapshots=3, tol_mu=1e-3)
    models_ = mod.ModelsConfig(convection=True, trilinear=True)
    return domain, fom, rom, walk, models_


def _same(a, b):
    assert type(a) is type(b) or (np.ndim(a) and np.ndim(b)), (a, b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b, (a, b)


@pytest.mark.parametrize("which", range(5))
def test_config_dicts_match_reference(which):
    port, ref = _configs(config)[which], _configs(ref_config)[which]
    _same(port.to_dict(), ref.to_dict())


def test_domain_config_grid():
    port, ref = _configs(config)[0], _configs(ref_config)[0]
    assert port.dt == ref.dt
    np.testing.assert_array_equal(port.timesteps(), ref.timesteps())


@pytest.mark.parametrize("kw", [dict(num_snapshots=0),
                                dict(num_snapshots=2, srom_truncate=-1)])
def test_rom_config_refuses(kw):
    for mod in (config, ref_config):
        with pytest.raises(ValueError):
            mod.RomConfig(**kw)


def test_pipeline_config_builds_driver():
    """``build`` hands the driver the reference's keyword arguments, the
    port's device beside them."""
    def pipeline(mod):
        domain, fom, rom, walk, models_ = _configs(mod)
        return mod.PipelineConfig(grid={"a0": (8.0, 10.0)}, fom=fom, rom=rom,
                                  deim=walk, mdeim=walk, models=models_,
                                  mdeim_nonlinear=walk, rnd=7)

    def capture(**kw):
        return kw

    port = pipeline(config).build(capture, device="cpu")
    ref = pipeline(ref_config).build(capture)
    assert port.pop("device") == "cpu"
    rnd_p, rnd_r = port.pop("rnd"), ref.pop("rnd")
    assert rnd_p.randint(1 << 30) == rnd_r.randint(1 << 30)
    _same(port, ref)


# ----------------------------------------------------------------------
# models/__init__.py
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(ref_models.MODEL_REGISTRY))
def test_get_model(name):
    cls = models.get_model(name)
    assert cls.__module__.startswith("romtime_tpu_torch.fom")
    assert cls.__name__ == ref_models.get_model(name).__name__


def test_get_model_unknown():
    assert sorted(models.MODEL_REGISTRY) == sorted(ref_models.MODEL_REGISTRY)
    with pytest.raises(KeyError, match="available"):
        models.get_model("navier-stokes")


# ----------------------------------------------------------------------
# utils/numeric.py (tests/test_utils.py)
# ----------------------------------------------------------------------
def test_compute_rom_difference_hand_computed():
    V_srom = np.array([[1.0, 0.0, 0.5], [0.0, 1.0, -0.5], [1.0, 1.0, 0.0],
                       [0.0, 0.0, 1.0]])
    uN, uN_srom = np.array([1.0, 2.0]), np.array([1.0, 2.0, 3.0])
    expected = np.linalg.norm(3.0 * V_srom[:, 2]) / np.sqrt(4)
    assert np.isclose(compute_rom_difference(uN, uN_srom, V_srom), expected)
    V = np.eye(4)[:, :3]
    u = np.array([0.3, -0.2, 0.9])
    assert compute_rom_difference(u, u, V) == 0.0


def test_time_average():
    ts = np.linspace(0.0, 2.0, 101)
    assert np.isclose(time_average(ts, 3.0 * np.ones_like(ts)), 3.0)


def test_singular_value_transforms():
    sigmas = np.array([3.0, 2.0, 1.0])
    energy = singular_to_energy(sigmas)
    assert np.isclose(energy[-1], 1.0) and np.all(np.diff(energy) > 0)
    pod_err = singular_to_pod_error(sigmas)
    assert np.isclose(pod_err[-1], 0.0)
    assert np.isclose(pod_err[0] ** 2, 4.0 + 1.0)


@pytest.mark.parametrize("name", ["singular_to_energy",
                                  "singular_to_pod_error",
                                  "eliminate_zeros_vector"])
def test_numeric_matches_reference(name):
    rng = np.random.default_rng(4)
    x = np.sort(rng.uniform(size=12))[::-1] * 1e3
    x[[3, 7]] = [0.0, 1e-17]
    port = {"singular_to_energy": singular_to_energy,
            "singular_to_pod_error": singular_to_pod_error,
            "eliminate_zeros_vector": eliminate_zeros_vector}[name]
    np.testing.assert_array_equal(port(x), getattr(ref_numeric, name)(x))


def test_project_dense_matches_reference():
    rng = np.random.default_rng(5)
    A, V = rng.normal(size=(9, 9)), np.linalg.qr(rng.normal(size=(9, 3)))[0]
    assert_allclose(project_dense(A, V), ref_numeric.project_dense(A, V),
                    rtol=1e-12)
    assert_allclose(project_dense(A, V), V.T @ A @ V, rtol=1e-12)
    assert eliminate_zeros_vector([1.0, 0.0, 1e-16, -2.0]).tolist() == [
        True, False, False, True]


# ----------------------------------------------------------------------
# utils/profiling.py and utils/progress.py
# ----------------------------------------------------------------------
def test_phase_timer():
    timer = PhaseTimer()
    for _ in range(2):
        with timer("offline/pod"):
            pass
    with pytest.raises(RuntimeError):
        with timer("online"):
            raise RuntimeError
    summary = timer.summary()
    assert list(summary) == ["offline/pod", "online"]
    assert summary["offline/pod"]["calls"] == 2
    assert summary["online"]["calls"] == 1
    assert "offline/pod" in timer.report() and "x2" in timer.report()


def test_block_and_time_on_the_cpu():
    calls = []
    seconds, out = block_and_time(
        lambda x: calls.append(1) or x * 2, torch.ones(3), repeats=3)
    assert len(calls) == 4 and seconds >= 0.0
    assert torch.equal(out, torch.full((3,), 2.0))


def test_torch_trace_writes_a_trace(tmp_path):
    with torch_trace(tmp_path / "trace"):
        torch.ones(8) @ torch.ones(8)
    assert any((tmp_path / "trace").iterdir())


@pytest.mark.parametrize("quiet", [False, True])
def test_progress(monkeypatch, capsys, quiet):
    monkeypatch.setenv("ROMTIME_PROGRESS", "0" if quiet else "1")
    assert list(progress(range(4), label="sweep")) == [0, 1, 2, 3]
    assert list(progress(iter("ab"), label="gen")) == ["a", "b"]
    err = capsys.readouterr().err
    if quiet:
        assert err == ""
    else:
        assert "[sweep] 4/4" in err and "[sweep] 1/4" in err
        assert "[gen] 1 " in err


# ----------------------------------------------------------------------
# The small FOM API (reference fom/base.py:187-197, :505, :794-847)
# ----------------------------------------------------------------------
def _piston_pair():
    ref = RefBurgers(**dict(zip(
        ("domain", "dirichlet", "forcing_term", "u0", "Lt", "dLt_dt"),
        ref_piston(**PISTON))), parameters=dict(PISTON_MU))
    ref.setup()
    port = OneDimensionalBurgers(**dict(zip(
        ("domain", "dirichlet", "forcing_term", "u0", "Lt", "dLt_dt"),
        define_piston_problem(**PISTON))), parameters=dict(PISTON_MU),
        device="cpu")
    port.setup()
    return ref, port


def _heat_pair(moving):
    mu = dict(HEAT_MU, omega=2.0 * np.pi / 8.0) if moving else HEAT_MU
    return (ref_solver(**HEAT, mu=dict(mu), moving=moving),
            port_solver(**HEAT, mu=dict(mu), moving=moving))


PAIRS = {"piston": _piston_pair, "heat": lambda: _heat_pair(False),
         "heat-moving": lambda: _heat_pair(True)}


@pytest.mark.parametrize("which", list(PAIRS))
def test_fom_geometry_matches_reference(which):
    ref, port = PAIRS[which]()
    assert_allclose(port.x, ref.x, rtol=1e-15)
    assert port.L == ref.L
    mu = dict(port.mu)
    ref.move_mesh(mu=mu, t=0.05)
    port.move_mesh(mu=mu, t=0.05)
    assert_allclose(port.L, ref.L, rtol=1e-12)
    assert_allclose(port.x, ref.x, rtol=1e-12)
    port.move_mesh(back=True)
    assert port.L == float(port.domain[port.L0])
    assert port.runtime_process(np.zeros(3)) is None


@pytest.mark.parametrize("which", list(PAIRS))
def test_fom_maps_match_reference(which):
    ref, port = PAIRS[which]()
    for entry in [(0,), (3,), (2, 5), (port.mesh.nh - 1,)]:
        assert port.find_cells_to_cover(entry) == ref.find_cells_to_cover(
            entry)
    table = {"a": [1.0, 2.0], "b": np.array([3.0, 4.0])}
    np.testing.assert_array_equal(port.dict_to_array(table),
                                  ref.dict_to_array(table))


@pytest.mark.parametrize("which", list(PAIRS))
def test_create_algebraic_solver(which):
    """The returned solver is the time loop's banded solve: it solves
    the assembled mass system as the reference's does."""
    import jax.numpy as jnp

    ref, port = PAIRS[which]()
    rng = np.random.default_rng(6)
    rhs = rng.normal(size=port.mesh.nh)
    with compute_dtype_scope(torch.float64):
        mu = {k: torch.tensor(float(v), dtype=torch.float64)
              for k, v in port.mu.items()}
        band = port.assemble_mass(mu, torch.tensor(0.05,
                                                   dtype=torch.float64)).band
        got = port.create_algebraic_solver()(
            band, torch.as_tensor(rhs)).numpy()
    want = np.asarray(ref.create_algebraic_solver()(
        ref.assemble_mass(dict(ref.mu), 0.05).band, jnp.asarray(rhs)))
    assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
    dense = port.assemble_mass(mu, torch.tensor(0.05, dtype=torch.float64)
                               ).todense()
    assert_allclose(dense @ got, rhs, atol=1e-10)


# ----------------------------------------------------------------------
# The plots
# ----------------------------------------------------------------------
@pytest.fixture
def agg():
    pytest.importorskip("matplotlib")
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    yield
    plt.close("all")


def test_utils_plots_write_files(agg, tmp_path):
    from romtime_tpu_torch.utils import plotting

    sol = SimpleNamespace(domain=np.tile(np.linspace(0, 1, 5)[:, None],
                                         (1, 7)),
                          fom=np.ones((5, 7)))
    plotting.plot_solution(sol, save=tmp_path / "sol.png")
    plotting.plot_errors(np.arange(4), [1e-3, 1e-4, 1e-5, 1e-6], log=True,
                         save=tmp_path / "err.png")
    plotting.plot_spectrum([1.0, 0.1, 0.01], energy=[0.9, 0.99, 1.0],
                           save=tmp_path / "spec.png")
    deim = SimpleNamespace(tree_walk_params={"ts": np.arange(3.0)},
                           errors_rom={0: [1e-3, 1e-4], 1: []}, name="rhs")
    plotting.plot_deim_errors(deim, save=tmp_path / "deim.png")
    for name in ("sol", "err", "spec", "deim"):
        assert (tmp_path / f"{name}.png").stat().st_size > 0


@pytest.mark.parametrize("moving", [False, True])
def test_fom_plots_write_files(agg, tmp_path, moving):
    _ref, port = _heat_pair(moving)
    with compute_dtype_scope(torch.float64):
        port.solve()
    port.plot_solution(save=tmp_path / "solution.png")
    port.plot_errors(save=tmp_path / "errors.png", log=True)
    port.plot_snapshots(save=tmp_path / "snapshots.png")
    for name in ("solution", "errors", "snapshots"):
        assert (tmp_path / f"{name}.png").stat().st_size > 0


def test_deim_plots_write_files(agg, tmp_path):
    """A trained DEIM and MDEIM of the heat family (the mock (M)DEIM
    setting of tests/test_torch_heat_deim.py) plot their spectra and
    online errors."""
    from romtime_tpu_torch.conventions import RomParameters
    from romtime_tpu_torch.deim import DiscreteEmpiricalInterpolation
    from romtime_tpu_torch.parameters import get_uniform_dist

    port = port_solver(**HEAT, mu=dict(HEAT_MU))
    grid = {"delta": get_uniform_dist(min=0.01, max=2.0),
            "beta": get_uniform_dist(min=1.0, max=10.0),
            "alpha_0": get_uniform_dist(min=0.01, max=2.0)}
    ts = np.linspace(0.1, 1.0, 10)
    deim = DiscreteEmpiricalInterpolation(
        assemble=port.assemble_forcing, grid=grid, name="rhs",
        tree_walk_params={RomParameters.TS: ts,
                          RomParameters.NUM_SNAPSHOTS: 3})
    deim.setup(rnd=np.random.RandomState(0))
    deim.run()
    deim.evaluate(ts=ts, num=2)
    deim.plot_spectrum(save=tmp_path / "spectrum.png")
    deim.plot_spectrum(which="energy", save=tmp_path / "energy.png")
    deim.plot_errors(save=tmp_path / "errors.png")
    for name in ("spectrum", "energy", "errors"):
        assert (tmp_path / f"{name}.png").stat().st_size > 0


def test_legacy_plots_write_files(agg, tmp_path):
    """The legacy drivers' reporting plots, on a driver whose summaries
    and ROM error series are set by hand."""
    from romtime_tpu_torch.problems.mfp1_legacy import (
        HyperReducedOrderModelFixed,
    )
    from romtime_tpu_torch.rom.base import Reductor

    drv = HyperReducedOrderModelFixed.__new__(HyperReducedOrderModelFixed)
    ts = np.linspace(0.1, 1.0, 10)
    drv.rom = SimpleNamespace(SPECTRUM_MU=Reductor.SPECTRUM_MU,
                              ENERGY_MU=Reductor.ENERGY_MU, timesteps=ts,
                              errors={0: np.full(10, 1e-4),
                                      1: np.full(8, 1e-5)})
    drv.summary_sigmas = {"rom": {Reductor.SPECTRUM_MU: [1.0, 0.1, 0.0]},
                          "deim": {}}
    drv.summary_energy = {"rom": {Reductor.ENERGY_MU: [0.9, 0.99, 1.0]}}
    drv.plot_spectrums(save=tmp_path / "spectrums")
    drv.plot_energy(save=tmp_path / "energy")
    drv.plot_errors(save=tmp_path / "errors", label="rom")
    for name in ("spectrums", "energy", "errors"):
        assert (tmp_path / f"{name}.png").stat().st_size > 0
