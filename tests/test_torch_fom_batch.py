"""The port's batched FOM sweep and the foundations it stands on, against
the JAX package's, on the CPU (romtime_tpu_torch/parallel/sweep.py,
fom/base.py's two time loops, parameters.py, utils/io.py).

``solve_fom_batch`` on 3 μ of the piston box at the conftest size
(nx=150, nt=96) against the reference's vmapped sweep: float64 plain and
dd within 1e-12 relative (rel-L2 per μ, tests/test_native_fom.py:59-62);
float32 plain and dd within the reference's own float32 limit, 1e-4
(tests/test_fom_dd.py:60-68), with the dd loop's contract of
tests/test_fom_dd.py held on the port itself (dd f64 ≡ plain f64 at
1e-11; the f32 dd drift under 1e-4 and under 5× the plain drift; low
words with 0 < |lo| < 1e-5·|hi|). With per-lane dilations (each μ on
its own grid T·d) each row equals that μ's own solve. The sampler
reproduces the reference's stream bit for bit (tests/test_parameters.py).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from romtime_tpu import parameters as ref_params
from romtime_tpu.dtypes import compute_dtype_scope as ref_dtype_scope
from romtime_tpu.fom import OneDimensionalBurgers as RefBurgers
from romtime_tpu.parallel.sweep import solve_fom_batch as ref_solve_fom_batch
from romtime_tpu.problems import define_piston_problem as ref_problem
from romtime_tpu_torch import parameters as params
from romtime_tpu_torch.convert import piston_fom
from romtime_tpu_torch.dtypes import compute_dtype_scope
from romtime_tpu_torch.parallel import solve_fom_batch
from romtime_tpu_torch.parallel.sweep import _mu_batch_dict
from romtime_tpu_torch.utils import io

jax.config.update("jax_enable_x64", True)

GRID = dict(L=1.0, nx=150, tf=0.6, nt=96)
MUS = [dict(a0=9.3, omega=17.5, delta=0.12, alpha=1e-6, gamma=1.4),
       dict(a0=8.4, omega=19.1, delta=0.105, alpha=1e-6, gamma=1.4),
       dict(a0=9.9, omega=15.6, delta=0.142, alpha=1e-6, gamma=1.4)]
KEYS = {"uh", "uc", "x", "t", "probes", "nonlinear_data"}
DTYPES = {"f64": (jnp.float64, torch.float64),
          "f32": (jnp.float32, torch.float32)}
#: Per-μ relative limits of port against reference: float64 at the
#: native-loop bound, float32 at the reference's own float32 limit.
LIMITS = {"f64": 1e-12, "f32": 1e-4}


def per_mu_rel(a, b):
    a = np.asarray(a, np.float64).reshape(len(b), -1)
    b = np.asarray(b, np.float64).reshape(len(b), -1)
    return np.linalg.norm(a - b, axis=1) / np.linalg.norm(b, axis=1)


def _pair(bdf="2"):
    d, bcs, forcing, u0, Lt, dLt = ref_problem(**GRID)
    ref = RefBurgers(domain=d, dirichlet=bcs, forcing_term=forcing, u0=u0,
                     Lt=Lt, dLt_dt=dLt)
    ref.BDF_SCHEME = bdf
    ref.setup()
    port = piston_fom(GRID["L"], GRID["nx"], GRID["tf"], GRID["nt"],
                      bdf=bdf, device="cpu")
    return ref, port


def _sweeps(ref, port, dd, dtype):
    ref.dd_sweep = port.dd_sweep = dd
    jdt, tdt = DTYPES[dtype]
    with ref_dtype_scope(jdt):
        want = ref_solve_fom_batch(ref, MUS)
    with compute_dtype_scope(tdt):
        got = solve_fom_batch(port, MUS)
    return got, want


def _trajectory(out):
    """hi + lo recombined in float64 (the dd sweep's trajectory)."""
    uh = out["uh"].astype(np.float64)
    return uh + out["uh_lo"] if "uh_lo" in out else uh


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture(scope="module")
def port_f64(pair):
    """The port's float64 plain sweep (the drift reference)."""
    _ref, port = pair
    port.dd_sweep = False
    with compute_dtype_scope(torch.float64):
        return solve_fom_batch(port, MUS)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("dd", [False, True])
def test_batch_matches_reference(pair, dd, dtype):
    ref, port = pair
    got, want = _sweeps(ref, port, dd, dtype)
    keys = KEYS | ({"uh_lo"} if dd else set())
    assert set(got) == set(want) == keys
    nt, nh = GRID["nt"], GRID["nx"] + 1
    for k in keys:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k
        assert np.isfinite(got[k]).all(), k
    assert got["uh"].shape == (3, nt, nh)
    assert got["nonlinear_data"].shape[:2] == (3, nt)
    assert got["probes"].shape == (3, nt, 3) and got["t"].shape == (3, nt)
    assert np.array_equal(got["t"], want["t"])
    limit = LIMITS[dtype]
    assert per_mu_rel(_trajectory(got), _trajectory(want)).max() < limit
    for k in ("uc", "probes", "nonlinear_data", "x"):
        assert per_mu_rel(got[k], want[k]).max() < limit, k


def test_dd_f64_matches_plain_f64(pair, port_f64):
    """tests/test_fom_dd.py:49-55 on the piston: in float64 the
    residual form is the direct step's algebra."""
    _ref, port = pair
    port.dd_sweep = True
    with compute_dtype_scope(torch.float64):
        dd = solve_fom_batch(port, MUS)
    assert per_mu_rel(_trajectory(dd), port_f64["uh"]).max() < 1e-11


def test_dd_f32_drift_and_low_words(pair, port_f64):
    """tests/test_fom_dd.py:58-68 and :90: the float32 dd drift stays
    under 1e-4 and under 5× the plain drift; the low words are genuine
    sub-float32 corrections."""
    _ref, port = pair
    drift = {}
    for dd in (False, True):
        port.dd_sweep = dd
        with compute_dtype_scope(torch.float32):
            out = solve_fom_batch(port, MUS)
        drift[dd] = per_mu_rel(_trajectory(out), port_f64["uh"]).max()
    assert drift[True] < 1e-4, drift
    assert drift[True] < 5.0 * drift[False], drift
    hi, lo = np.abs(out["uh"]).max(), np.abs(out["uh_lo"]).max()
    assert 0 < lo < 1e-5 * hi


@pytest.mark.parametrize("dd", [False, True])
def test_bdf1_matches_reference(dd):
    """The BDF-1 branches of both loops (bdf 1 at every step, no
    history), float64."""
    ref, port = _pair(bdf="1")
    got, want = _sweeps(ref, port, dd, "f64")
    assert per_mu_rel(_trajectory(got), _trajectory(want)).max() < 1e-12
    assert per_mu_rel(got["probes"], want["probes"]).max() < 1e-12


def test_one_mu_and_dict_batches(pair, monkeypatch):
    """A one-μ list gives a leading axis of 1; a dict of arrays is a
    batch as it stands; solve() on the eager loop equals its batch row
    (the native loop, a float64 solve's default, is held against the
    eager loop in tests/test_torch_native.py)."""
    _ref, port = pair
    port.dd_sweep = False
    monkeypatch.setenv("ROMTIME_NATIVE_FOM", "0")
    with compute_dtype_scope(torch.float64):
        one = solve_fom_batch(port, MUS[:1])
        as_dict = solve_fom_batch(port, {k: np.array([MUS[0][k]])
                                         for k in MUS[0]})
        port.update_parametrization(MUS[0])
        port.solve()
    assert one["uh"].shape == (1, GRID["nt"], GRID["nx"] + 1)
    for k in one:
        assert np.array_equal(one[k], as_dict[k]), k
    assert_allclose(port.solutions.snapshots, one["uh"][0].T, rtol=1e-13,
                    atol=1e-16)
    batch = _mu_batch_dict(MUS, device="cpu")
    assert list(batch) == sorted(MUS[0])
    assert batch["a0"].dtype == torch.float32
    assert batch["a0"].tolist() == pytest.approx([m["a0"] for m in MUS])


def test_per_lane_dilations_match_the_serial_solves(pair, monkeypatch):
    """``dilations``: each μ on its own grid T·d over the same nt steps in
    one sweep (how a registered cell's training set is re-solved), each
    row equal to that μ's ``solve()`` at T·d on the eager loop as the
    reference re-solves it (rom/hrom.py:947-975; the native loop is held
    against the eager one in tests/test_torch_native.py), the reference's
    sweep on its own dilated grid within 1e-12; T restored; the clock
    (B, nt) per lane."""
    ref, port = pair
    ref.dd_sweep = port.dd_sweep = False
    monkeypatch.setenv("ROMTIME_NATIVE_FOM", "0")
    dils = [1.0, 1.021, 1.17]
    T = port.domain[port.T]
    with compute_dtype_scope(torch.float64):
        got = solve_fom_batch(port, MUS, dilations=dils)
    assert port.domain[port.T] == T
    assert got["t"].shape == (3, GRID["nt"])
    t_ref = ref.domain[ref.T]
    for b, (mu, d) in enumerate(zip(MUS, dils)):
        assert_allclose(got["t"][b], np.arange(1, GRID["nt"] + 1) * T * d
                        / GRID["nt"], rtol=1e-15)
        with compute_dtype_scope(torch.float64):
            port.domain[port.T] = T * d
            try:
                port.update_parametrization(mu)
                port.solve()
            finally:
                port.domain[port.T] = T
        for key, serial in (("uh", port.solutions.snapshots.T),
                            ("uc", port.solutions.fom.T),
                            ("nonlinear_data",
                             np.asarray(port.nonlinear_snapshots))):
            assert_allclose(got[key][b], serial, rtol=1e-13, atol=1e-16,
                            err_msg=key)
        try:
            ref.domain[ref.T] = t_ref * d
            ref._solve_jit = {}
            with ref_dtype_scope(jnp.float64):
                want = ref_solve_fom_batch(ref, [mu])
        finally:
            ref.domain[ref.T] = t_ref
            ref._solve_jit = {}
        for key in ("uh", "uc", "probes", "nonlinear_data"):
            assert per_mu_rel(got[key][b:b + 1], want[key])[0] <= 1e-12, key


def test_sweep_refuses_tf32():
    """The loops run only with full float32 contractions."""
    from romtime_tpu_torch.dtypes import full_f32_matmul

    _ref, port = _pair()
    mu = _mu_batch_dict(MUS, device="cpu")
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="TF32"):
            port._solve_impl(mu)
        with full_f32_matmul():
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(saved)


# ---------------------------------------------------------------------------
# parameters.py (tests/test_parameters.py)
# ---------------------------------------------------------------------------
def test_parameter_handler():
    """The reference's literal expected values (sklearn's stream)."""
    grid = {
        "alpha": params.get_uniform_dist(min=1.0, max=10.0),
        "delta": params.get_uniform_dist(min=-10.0, max=5.0),
        "epsilon": params.get_uniform_dist(min=0.0, max=1.0),
        "beta": [0.5],
    }
    sampler = params.ParameterSampler(param_distributions=grid, n_iter=5,
                                      random_state=np.random.RandomState(0))
    assert len(sampler) == 5
    assert params.round_parameter_list(list(sampler), num=2) == [
        {"alpha": 5.94, "beta": 0.5, "delta": 0.73, "epsilon": 0.6},
        {"alpha": 5.9, "beta": 0.5, "delta": -3.65, "epsilon": 0.65},
        {"alpha": 4.94, "beta": 0.5, "delta": 3.38, "epsilon": 0.96},
        {"alpha": 4.45, "beta": 0.5, "delta": 1.88, "epsilon": 0.53},
        {"alpha": 6.11, "beta": 0.5, "delta": 3.88, "epsilon": 0.07},
    ]


@pytest.mark.parametrize("seed", [7, 2024])
def test_sampler_stream_equals_reference(seed):
    """Bit for bit against the reference's sampler: distributions, lists,
    an int seed and a RandomState, and sample_parameters."""
    grid = {"a0": (8.0, 10.0), "omega": (15.0, 20.0), "delta": (0.1, 0.15),
            "gamma": (1.4, 1.4)}
    port_grid = {k: params.get_uniform_dist(*v) for k, v in grid.items()}
    ref_grid = {k: ref_params.get_uniform_dist(*v) for k, v in grid.items()}
    port_grid["mode"] = ref_grid["mode"] = ["a", "b", "c"]
    got = list(params.ParameterSampler(port_grid, 6, random_state=seed))
    want = list(ref_params.ParameterSampler(ref_grid, 6, random_state=seed))
    assert got == want
    assert (params.sample_parameters(port_grid, 4, np.random.RandomState(seed))
            == ref_params.sample_parameters(ref_grid, 4,
                                            np.random.RandomState(seed)))


def test_parameters_helpers():
    mus = [{"a": 1.0, "b": 2.0}, {"a": 3.0, "b": 4.0}]
    arr, names = params.parameters_to_array(mus)
    assert names == ["a", "b"] and arr.shape == (2, 2)
    assert params.array_to_parameters(arr, names) == mus
    arr_b, names_b = params.parameters_to_array(mus, names=["b", "a"])
    assert names_b == ["b", "a"] and arr_b[0].tolist() == [2.0, 1.0]
    assert params.round_parameters({"a": 1.23456}, num=2) == {"a": 1.23}
    rng = np.random.RandomState(1)
    assert params.check_random_state(rng) is rng
    assert isinstance(params.check_random_state(None), np.random.RandomState)
    with pytest.raises(ValueError):
        params.check_random_state("seed")


# ---------------------------------------------------------------------------
# utils/io.py
# ---------------------------------------------------------------------------
def test_dump_csv_writes_the_pandas_table(tmp_path):
    """dump_csv without pandas: the text pandas.DataFrame(obj).to_csv
    writes, a scalar filling its column."""
    from romtime_tpu.utils.io import dump_csv as ref_dump_csv

    rng = np.random.default_rng(0)
    obj = {"which": "fom", "timesteps": np.linspace(0.01, 0.3, 7),
           "mass": 1.0 + rng.normal(size=7) * 1e-3,
           "mass_change": rng.normal(size=7) * 1e-9,
           "count": np.arange(7), "f32": rng.normal(size=7).astype(np.float32)}
    io.dump_csv(str(tmp_path / "port.csv"), obj)
    ref_dump_csv(str(tmp_path / "ref.csv"), obj)
    assert ((tmp_path / "port.csv").read_text()
            == (tmp_path / "ref.csv").read_text())


def test_pickle_json_npz_roundtrip(tmp_path):
    obj = {"a": np.arange(3.0), "b": np.float64(2.5), "c": np.int64(4)}
    io.dump_pickle(str(tmp_path / "o.pkl"), obj)
    back = io.read_pickle(str(tmp_path / "o.pkl"))
    assert np.array_equal(back["a"], obj["a"]) and back["b"] == 2.5
    io.dump_json(str(tmp_path / "o.json"), obj)
    assert io.read_json(str(tmp_path / "o.json")) == {
        "a": [0.0, 1.0, 2.0], "b": 2.5, "c": 4}
    with pytest.raises(TypeError):
        json.dumps(object(), default=io._json_default)
    io.dump_npz(str(tmp_path / "o.npz"), x=np.eye(2), y=np.arange(2))
    back = io.read_npz(str(tmp_path / "o.npz"))
    assert np.array_equal(back["x"], np.eye(2)) and list(back) == ["x", "y"]


def test_sampler_refuses_other_distributions():
    """The sampler draws frozen uniforms as scipy does and raises for any
    other distribution rather than drawing it another way."""
    from scipy.stats import norm

    with pytest.raises(ValueError, match="uniforms"):
        list(params.ParameterSampler({"a": norm(0.0, 1.0)}, 2,
                                     random_state=0))
