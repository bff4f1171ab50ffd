"""The port's heat drivers (romtime_tpu_torch/rom/hrom.py
``HyperReducedOrderModelFixed``/``Moving``, problems/mfp1_legacy.py) and
the heat family's windowed serving against the JAX package.

Both packages build the pipeline of tests/test_hrom.py ``_heat_config``
once per module (fixed: nx=80, nt=50; moving: nx=60, nt=30; the JAX
side's POD SVD through numpy, tests/torch_parity.py), each in its own
temporary directory. Anchors: tests/test_hrom.py:94-232 (offline,
validation, online evaluation with the estimator, ``estimate_batch``
against the serial estimator, resume from disk) and :236-260 (moving).
The legacy drivers and the windowed heat serving are in
tests/test_torch_heat_legacy.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from romtime_tpu.conventions import Stage as RefStage
from romtime_tpu.dtypes import compute_dtype_scope as ref_dtype_scope
from romtime_tpu_torch.conventions import (
    Errors,
    OperatorType,
    RomParameters,
    Stage,
)
from romtime_tpu_torch.dtypes import compute_dtype_scope
from romtime_tpu_torch.parameters import get_uniform_dist
from romtime_tpu_torch.problems import define_mfp1_problem
from romtime_tpu_torch.rom import (
    HyperReducedOrderModelFixed,
    HyperReducedOrderModelMoving,
    RomConstructor,
    RomConstructorMoving,
)
from romtime_tpu_torch.utils import compute_rom_difference
from torch_parity import _numpy_svd

jax.config.update("jax_enable_x64", True)

F64 = torch.float64


def port_config(nx=80, nt=50, tf=10.0, L=2.0, moving=False):
    """tests/test_hrom.py:27-67 with the port's callables."""
    domain, bcs, forcing, u0, ue, Lt, dLt_dt = define_mfp1_problem(L, nx, tf,
                                                                   nt)
    grid = {"delta": get_uniform_dist(min=0.01, max=2.0),
            "beta": get_uniform_dist(min=1.0, max=10.0),
            "alpha_0": get_uniform_dist(min=0.01, max=2.0)}
    if moving:
        omegas = [(1.0 / tf) * np.arcsin(1.0 - n) for n in (0.5, 0.8)]
        grid["omega"] = get_uniform_dist(min=min(omegas), max=max(omegas))
    fom_params = dict(domain=domain, dirichlet=bcs, forcing_term=forcing,
                      u0=u0, exact_solution=ue,
                      grid_params={k: "uniform" for k in grid})
    if moving:
        fom_params.update(Lt=Lt, dLt_dt=dLt_dt)
    ts = np.linspace(tf / nt, tf, nt)
    rom_params = {RomParameters.NUM_SNAPSHOTS: 4,
                  RomParameters.SROM_TRUNCATE: 2,
                  RomParameters.TOL_TIME: None, RomParameters.TOL_MU: None}
    deim_params = {RomParameters.TS: ts, RomParameters.NUM_SNAPSHOTS: 6}
    mdeim_params = {RomParameters.TS: ts, RomParameters.NUM_SNAPSHOTS: 6}
    models = {OperatorType.MASS: True, OperatorType.STIFFNESS: True,
              OperatorType.RHS: True, OperatorType.CONVECTION: moving}
    return grid, fom_params, rom_params, deim_params, mdeim_params, models


def build(cls, config, workdir, evaluate=True, **kw):
    grid, fp, rp, dp, mp, models = config
    with pytest.MonkeyPatch.context() as m:
        m.chdir(workdir)
        hrom = cls(grid=grid, fom_params=fp, rom_params=rp, deim_params=dp,
                   mdeim_params=mp, models=models,
                   rnd=np.random.RandomState(0), **kw)
        hrom.setup()
        hrom.setup_hyperreduction()
        hrom.run_offline_rom()
        hrom.run_offline_hyperreduction(
            mu_space=hrom.mu_space[Stage.OFFLINE], evaluate=evaluate)
        hrom.project_reductors()
    return hrom


def ref_build(moving, workdir, nx, nt, legacy=False):
    from test_hrom import _heat_config

    if legacy:
        from romtime_tpu.problems import mfp1_legacy as mod
    else:
        from romtime_tpu.rom import hrom as mod
    cls = (mod.HyperReducedOrderModelMoving if moving
           else mod.HyperReducedOrderModelFixed)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jnp.linalg, "svd", _numpy_svd)
        return build(cls, _heat_config(nx=nx, nt=nt, moving=moving),
                     workdir)


def span_gap(V, W):
    """‖P_V − P_W‖₂ of two orthonormal bases' projectors."""
    V, W = np.asarray(V), np.asarray(W)
    return np.linalg.norm(V @ V.T - W @ W.T, 2)


@pytest.fixture(scope="module")
def fixed_pair(tmp_path_factory):
    ref = ref_build(False, tmp_path_factory.mktemp("ref_fixed"), 80, 50)
    workdir = tmp_path_factory.mktemp("port_fixed")
    port = build(HyperReducedOrderModelFixed, port_config(), workdir,
                 device="cpu")
    return ref, port, workdir


@pytest.fixture(scope="module")
def moving_pair(tmp_path_factory):
    ref = ref_build(True, tmp_path_factory.mktemp("ref_moving"), 60, 30)
    port = build(HyperReducedOrderModelMoving,
                 port_config(nx=60, nt=30, moving=True),
                 tmp_path_factory.mktemp("port_moving"), device="cpu")
    return ref, port


def _dof_set(red):
    return {tuple(int(v) for v in np.atleast_1d(d)) for d in red.dofs}


def assert_same_dofs(port_red, ref_red):
    """The same dofs as sets or, where the greedy met a tie up to
    rounding (the stated TIE_RTOL departure: the reference's np.argmax
    follows the rounding), the port's own greedy's picks on the
    reference's collateral basis."""
    from romtime_tpu_torch.deim.deim import greedy_numpy

    got, want = _dof_set(port_red), _dof_set(ref_red)
    if got == want:
        return
    picks, _P = greedy_numpy(np.asarray(ref_red.basis_fom),
                             port_red._forbidden_greedy_positions())
    entry = getattr(port_red, "get_entry", lambda i: (i,))
    assert got == {tuple(int(v) for v in entry(i)) for i in picks}


@pytest.mark.parametrize("family", ["fixed", "moving"])
def test_offline_matches_reference(family, fixed_pair, moving_pair):
    """tests/test_hrom.py:94-104: the ROM/S-ROM pair (N + 2), the same
    offline μ, bases spanning the same space (1e-8), the same dofs
    (:func:`assert_same_dofs`), and the affine operators' DEIM errors
    under 1e-10."""
    ref, port = (fixed_pair if family == "fixed" else moving_pair)[:2]
    rom_cls = RomConstructor if family == "fixed" else RomConstructorMoving
    assert type(port.rom) is rom_cls and type(port.srom) is rom_cls
    assert port.rom.N == ref.rom.N and port.srom.N == ref.srom.N
    assert port.srom.N == port.rom.N + 2
    assert port.deim_runned
    for a, b in zip(port.mu_space[Stage.OFFLINE],
                    ref.mu_space[RefStage.OFFLINE]):
        assert a == pytest.approx({k: float(v) for k, v in b.items()},
                                  rel=1e-15)
    assert span_gap(port.srom.basis, ref.srom.basis) < 1e-8
    names = ["deim_rhs", "mdeim_mass", "mdeim_stiffness"]
    if family == "moving":
        names.append("mdeim_convection")
        assert port.deim_moving_runned
    for name in names:
        assert_same_dofs(getattr(port, name), getattr(ref, name))
        errs = np.concatenate([np.atleast_1d(v) for v in
                               getattr(port, name).errors_rom.values()
                               if np.size(v)])
        assert errs.mean() < 1e-10


@pytest.mark.parametrize("family", ["fixed", "moving"])
def test_validation_matches_reference(family, fixed_pair, moving_pair,
                                      tmp_path, monkeypatch):
    """tests/test_hrom.py:107-118: ``evaluate_validation`` keeps each
    offline μ's exact-solution error series, within 1e-6 relative of the
    JAX package's; ``generate_summary`` fills its tables."""
    ref, port = (fixed_pair if family == "fixed" else moving_pair)[:2]
    monkeypatch.chdir(tmp_path)
    with compute_dtype_scope(F64):
        port.evaluate_validation()
    with ref_dtype_scope(jnp.float64):
        ref.evaluate_validation()
    got, want = port.errors[Stage.VALIDATION], ref.errors[RefStage.VALIDATION]
    assert sorted(got) == sorted(want)
    for idx in want:
        w = np.asarray(want[idx])
        assert np.abs(np.asarray(got[idx]) - w).max() <= 1e-6 * np.abs(w).max()
    port.generate_summary()
    assert port.summary_basis["index"] and port.summary_errors["index"]


def test_online_and_estimator(fixed_pair, tmp_path, monkeypatch):
    """tests/test_hrom.py:121-160: the exact solution hidden, two fresh
    μ against the FOM: each series' shape, the S-ROM at least as good on
    average, the estimator within [0.8, 1.25] of the true error; the
    three series within 1e-6 of the JAX package's, relative to the ROM
    error (the S-ROM's, ~1e-10, sits at the FOM's rounding)."""
    ref, port, _ = fixed_pair
    monkeypatch.chdir(tmp_path)
    exact = (port.fom.exact_solution, ref.fom.exact_solution)
    port.fom.exact_solution = ref.fom.exact_solution = None
    ref.fom._solve_jit = None
    try:
        with compute_dtype_scope(F64):
            port.evaluate_online(params={"num": 2},
                                 rnd=np.random.RandomState(5))
        ref.rom._online_fns = {}
        ref.srom._online_fns = {}
        with ref_dtype_scope(jnp.float64):
            ref.evaluate_online(params={"num": 2},
                                rnd=np.random.RandomState(5))
    finally:
        port.fom.exact_solution, ref.fom.exact_solution = exact
        ref.fom._solve_jit = None
        ref.rom._online_fns = {}
        ref.srom._online_fns = {}
    errors = port.errors[Stage.ONLINE]
    assert len(errors) == 2
    for idx, payload in errors.items():
        rom_err = payload[Errors.ROM]
        srom_err = payload[Errors.SACRIFICIAL]
        est = payload[Errors.ESTIMATOR]
        assert rom_err.shape == srom_err.shape == est.shape
        assert srom_err.mean() <= 2.0 * rom_err.mean()
        assert 0.8 < est.mean() / max(rom_err.mean(), 1e-16) < 1.25
        # Relative to the ROM's error: the S-ROM's sits near rounding.
        scale = np.abs(ref.errors[RefStage.ONLINE][idx][Errors.ROM]).max()
        for key in (Errors.ROM, Errors.SACRIFICIAL, Errors.ESTIMATOR):
            w = np.asarray(ref.errors[RefStage.ONLINE][idx][key])
            assert np.abs(payload[key] - w).max() <= 1e-6 * scale, key


def test_estimate_batch_matches_serial(fixed_pair):
    """tests/test_hrom.py:163-196: the batched S-ROM estimator (the
    global lanes engine in float64) equals the serial reconstruction
    (rtol 1e-8, atol 1e-13) and the JAX package's batch (1e-8·scale)."""
    ref, port, _ = fixed_pair
    mus = [dict(m) for m in port.rom.build_sampling_space(
        num=2, rnd=np.random.RandomState(7))]
    with compute_dtype_scope(F64):
        out = port.estimate_batch(mus, step=Stage.ONLINE)
        est = out[Errors.ESTIMATOR]
        assert est.shape[0] == 2
        assert out[Errors.AVERAGE_ESTIMATOR].shape == (2,)
        assert np.all(out[Errors.AVERAGE_ESTIMATOR] >= 0)
        V_srom = port.srom.basis
        for b, mu in enumerate(mus):
            port.rom.solve(mu=dict(mu), step=Stage.VALIDATION)
            port.srom.solve(mu=dict(mu), step=Stage.VALIDATION)
            uNs, uNs_srom = port.rom.solutions.rom, port.srom.solutions.rom
            serial = np.array([compute_rom_difference(
                uN=uNs[:, i], uN_srom=uNs_srom[:, i], V_srom=V_srom)
                for i in range(uNs.shape[1])])
            assert_allclose(est[b], serial, rtol=1e-8, atol=1e-13)
    with ref_dtype_scope(jnp.float64):
        want = ref.estimate_batch(mus, step=RefStage.ONLINE)[
            Errors.ESTIMATOR]
    assert np.abs(est - want).max() <= 1e-8 * np.abs(want).max()


def test_resume_from_existing_basis(fixed_pair, tmp_path, monkeypatch):
    """tests/test_hrom.py:199-232: the dumps, then a fresh driver's
    ``start_from_existing_basis``: the same N and S-ROM basis, and the
    same solve (1e-10)."""
    _ref, hrom, workdir = fixed_pair
    monkeypatch.chdir(workdir)
    hrom.dump_mu_space()
    hrom.dump_reduced_basis()
    for obj in (hrom.deim_rhs, hrom.mdeim_mass, hrom.mdeim_stiffness):
        obj.dump_fom_basis()
    config = port_config()
    config[2][RomParameters.SROM_KEEP] = hrom.srom.N
    grid, fp, rp, dp, mp, models = config
    fresh = HyperReducedOrderModelFixed(
        grid=grid, fom_params=fp, rom_params=rp, deim_params=dp,
        mdeim_params=mp, models=models, rnd=np.random.RandomState(0),
        device="cpu")
    fresh.setup()
    fresh.setup_hyperreduction()
    fresh.start_from_existing_basis()
    fresh.project_reductors()
    assert fresh.rom.N == hrom.rom.N
    assert np.allclose(fresh.srom.basis, hrom.srom.basis)
    mu = hrom.mu_space[Stage.OFFLINE][0]
    with compute_dtype_scope(F64):
        fresh.rom.solve(mu=mu, step=Stage.ONLINE)
        hrom.rom.solve(mu=mu, step=Stage.ONLINE)
    assert np.allclose(fresh.rom.solutions.fom, hrom.rom.solutions.fom,
                       atol=1e-10)


@pytest.mark.parametrize("family", ["fixed", "moving"])
def test_global_serving_without_trilinear(family, fixed_pair, moving_pair):
    """The built heat ROM serves ``mode="probes"`` at B=128 in float32
    through the global kernels (K4's twin, then K5's with the budget at
    0; ``with_trilinear=False``, BDF-1): within 3e-5·scale of the float32
    global lanes engine (``uN_final`` 1e-4·max(|uN|, 1)), K5 within
    3e-6·scale of K4 (tests/test_rom.py:196-200, :226-227)."""
    _ref, port = (fixed_pair if family == "fixed" else moving_pair)[:2]
    rom = port.rom
    mus = [dict(m) for m in rom.build_sampling_space(
        num=128, rnd=np.random.RandomState(3))]
    assert rom._resolve_engine("probes", 128) == "pallas"
    lanes = rom.solve_batch(mus, mode="probes", engine="lanes")
    k4 = rom.solve_batch(mus, mode="probes")
    rom.ONLINE_PRECOMPUTE_BUDGET = 0
    try:
        k5 = rom.solve_batch(mus, mode="probes")
    finally:
        del rom.ONLINE_PRECOMPUTE_BUDGET
    uscale = max(np.abs(lanes["uN_final"]).max(), 1.0)
    scale = np.abs(lanes["probes"]).max()
    for got in (k4, k5):
        assert np.abs(got["probes"] - lanes["probes"]).max() <= 3e-5 * scale
        assert (np.abs(got["uN_final"] - lanes["uN_final"]).max()
                <= 1e-4 * uscale)
    assert np.abs(k5["probes"] - k4["probes"]).max() <= 3e-6 * scale
    assert (np.abs(k5["uN_final"] - k4["uN_final"]).max()
            <= 3e-6 * max(np.abs(k4["uN_final"]).max(), 1.0))
