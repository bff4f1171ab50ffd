"""The port's phase registration (romtime_tpu_torch/rom/registration.py:
``resample_time``, ``optimal_dilation``, ``fit_dilation_law`` with its
auto feature selection and guard, ``resample_to_standard``) and the
registered μ-local build (``HyperReducedPiston.build_mulocal_serving(
register=...)``, its float64 re-solves on each μ's dilated grid) against the JAX package's.

Each unit test of tests/test_registration.py is mirrored on the same
inputs through both packages' functions: dilations within 1e-10, law
coefficients within 1e-9 relative, plus the reference test's own
assertions on the port's result. The registered build runs at the
reference fixture's settings (``piston_registered``,
tests/test_registration.py:418: K=2, W=4, N=12, 3 μ a cell,
RandomState(2), ``register=[1]``) on each package's own build of the
conftest piston pipeline (the reference's through
tests/torch_parity.build_piston_hrom, its SVD routed through numpy; the
port's through tests/test_torch_offline_build.port_build), each in its
own working directory, in float64: the same training μ, the same law
(names, coefficients within 1e-9 relative, training dilations within
1e-10), window bases of the same span (1e-8), and the port's float64
windowed lanes trajectories within 1e-9·scale of the reference's."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romtime_tpu.conventions import Stage as RefStage
from romtime_tpu.rom import registration as ref_reg
from romtime_tpu.rom.windowed import MuLocalWindowed as RefMuLocalWindowed
from romtime_tpu_torch.conventions import Stage, StorageNames
from romtime_tpu_torch.dtypes import compute_dtype_scope
from romtime_tpu_torch.rom import registration as reg
from romtime_tpu_torch.rom.windowed import MuLocalWindowed
from test_torch_offline_build import port_build
from torch_parity import _numpy_svd, build_piston_hrom

jax.config.update("jax_enable_x64", True)

MU_LO = dict(a0=9.8, omega=15.5, delta=0.10, alpha=1e-6, gamma=1.4)
MU_HI = dict(a0=8.1, omega=19.5, delta=0.148, alpha=1e-6, gamma=1.4)
#: tests/test_registration.py:418-434's fleet.
REGISTERED = dict(n_cells=2, n_windows=4, num_basis=12,
                  snapshots_per_cell=3, register=[1])


def _wave(nh, nt, speed, k=3.0):
    """tests/test_registration.py:30-34's traveling wave."""
    x = np.linspace(0, 1, nh)[:, None]
    t = np.linspace(0, 1, nt)[None, :]
    return np.sin(2 * np.pi * k * (x - speed * t)) * np.exp(-0.3 * t)


def _assert_laws_equal(got, want):
    assert got.names == want.names
    np.testing.assert_allclose(got.coef, want.coef, rtol=1e-9, atol=0)
    assert got.floor == want.floor
    assert got.has_guard == want.has_guard
    if want.has_guard:
        np.testing.assert_allclose(got.guard_feats, want.guard_feats,
                                   rtol=1e-12)
        np.testing.assert_allclose(got.guard_inv_span, want.guard_inv_span,
                                   rtol=1e-12)
        assert abs(got.guard_dref - want.guard_dref) <= 1e-12 * want.guard_dref


# ---------------------------------------------------------------------------
# The primitives (tests/test_registration.py:37-256)
# ---------------------------------------------------------------------------
def test_optimal_dilation_recovers_known_phase():
    anchor = _wave(120, 400, speed=1.0)
    for d_true in (0.95, 1.03):
        u = _wave(120, 400, speed=1.0 / d_true)
        d = reg.optimal_dilation(u, anchor, lo=0.9, hi=1.1)
        assert abs(d - ref_reg.optimal_dilation(u, anchor, lo=0.9,
                                                hi=1.1)) <= 1e-10
        assert abs(d - d_true) < 2e-3, (d_true, d)


def test_fit_dilation_law_linear_recovery():
    rng = np.random.default_rng(0)
    mus = [dict(a0=float(a), omega=float(w), delta=0.12)
           for a, w in zip(rng.uniform(8, 10, 8), rng.uniform(15, 20, 8))]
    d_true = np.array([1.0 + 0.01 * (m["a0"] - 9) - 0.004 * (m["omega"] - 17)
                       for m in mus])
    snaps = [_wave(100, 500, speed=1.0 / d) for d in d_true]
    law, dils = reg.fit_dilation_law(snaps, mus, anchor=0, margin=0.01)
    ref_law, ref_dils = ref_reg.fit_dilation_law(snaps, mus, anchor=0,
                                                 margin=0.01)
    np.testing.assert_allclose(dils, ref_dils, rtol=0, atol=1e-10)
    _assert_laws_equal(law, ref_law)
    assert np.all(dils >= 1.0 + 0.01 - 1e-9)
    np.testing.assert_allclose(dils, d_true * dils[0] / d_true[0], rtol=4e-3)
    pred = np.array([law.predict(m) for m in mus])
    np.testing.assert_allclose(pred, dils, rtol=2e-3)
    np.testing.assert_allclose(
        pred, [ref_law.predict(m) for m in mus], rtol=1e-12)


def test_fit_dilation_law_boundary_raises():
    anchor = _wave(80, 300, speed=1.0)
    runaway = _wave(80, 300, speed=1.0 / 1.3)
    for fit in (reg.fit_dilation_law, ref_reg.fit_dilation_law):
        with pytest.raises(ValueError, match="boundary"):
            fit([anchor, runaway], [dict(a0=9.0), dict(a0=8.0)],
                features=("a0",), search=(0.9, 1.1))


def test_resample_to_standard_inverts_dilation():
    nt, d = 600, 1.03
    t_dil = np.arange(1, nt + 1) * d / nt
    t_std = np.arange(1, nt + 1) / nt
    traj = np.stack([np.sin(7.0 * t_dil), np.cos(11.0 * t_dil)], axis=1)
    out = reg.resample_to_standard(traj, d, axis=0)
    np.testing.assert_allclose(
        out, ref_reg.resample_to_standard(traj, d, axis=0), rtol=0,
        atol=1e-15)
    ref = np.stack([np.sin(7.0 * t_std), np.cos(11.0 * t_std)], axis=1)
    assert np.max(np.abs(out - ref)) < 1e-8
    np.testing.assert_array_equal(reg.resample_to_standard(traj, 1.0), traj)
    # Along another axis, as the certification resamples (nh, nt) fields.
    np.testing.assert_array_equal(
        reg.resample_to_standard(traj.T, d, axis=1), out.T)


def test_feature_grammar():
    mu = dict(a0=8.0, omega=20.0, delta=0.15)
    for name in ("a0", "a0^2", "delta*omega*a0^-1", "a0*omega", "omega^-2"):
        assert reg._feature_value(mu, name) == ref_reg._feature_value(
            mu, name), name
    assert reg._feature_value(mu, "a0") == 8.0
    assert reg._feature_value(mu, "a0^2") == 64.0
    assert np.isclose(reg._feature_value(mu, "delta*omega*a0^-1"),
                      0.15 * 20.0 / 8.0)
    assert np.isclose(reg._feature_value(mu, "a0*omega"), 160.0)
    assert reg.FEATURE_CANDIDATES == ref_reg.FEATURE_CANDIDATES
    mus = [mu, dict(a0=9.0, omega=16.0, delta=0.11)]
    for names in reg.FEATURE_CANDIDATES:
        X = reg._design_matrix(mus, names)
        np.testing.assert_array_equal(X, ref_reg._design_matrix(mus, names))
    y = np.array([1.0, 1.1])
    X = reg._design_matrix(mus * 2, ("a0",))
    assert reg._loo_rms(X, np.tile(y, 2)) == ref_reg._loo_rms(X,
                                                              np.tile(y, 2))


def test_fit_auto_selects_quadratic_when_needed():
    rng = np.random.default_rng(3)
    mus = [dict(a0=float(a), omega=float(w), delta=0.12)
           for a, w in zip(rng.uniform(8, 10, 14), rng.uniform(15, 20, 14))]
    d_true = np.array([1.0 + 0.02 * (m["a0"] - 9) ** 2
                       - 0.004 * (m["omega"] - 17) for m in mus])
    snaps = [_wave(100, 500, speed=1.0 / d) for d in d_true]
    law, dils = reg.fit_dilation_law(snaps, mus, features="auto",
                                     search=(0.9, 1.15))
    ref_law, ref_dils = ref_reg.fit_dilation_law(snaps, mus, features="auto",
                                                 search=(0.9, 1.15))
    np.testing.assert_allclose(dils, ref_dils, rtol=0, atol=1e-10)
    _assert_laws_equal(law, ref_law)
    assert any("^2" in n or "*" in n for n in law.names), law.names
    pred = np.array([law.predict(m) for m in mus])
    np.testing.assert_allclose(pred, dils, rtol=3e-3)


def test_resample_time_known_shift():
    u = _wave(50, 300, speed=1.0)
    np.testing.assert_allclose(reg.resample_time(u, 1.0), u, atol=0)
    for d in (1.05, 0.93):
        r = reg.resample_time(u, d)
        assert r.shape == u.shape
        np.testing.assert_array_equal(r, ref_reg.resample_time(u, d))
    np.testing.assert_array_equal(reg.resample_time(u, 1.05, nt=120),
                                  ref_reg.resample_time(u, 1.05, nt=120))


def test_fitted_law_carries_guard_and_flags_holes():
    rng = np.random.default_rng(7)
    a_lo = rng.uniform(8.0, 8.3, 5)
    a_hi = rng.uniform(9.7, 10.0, 5)
    mus = [dict(a0=float(a), omega=float(w), delta=0.12)
           for a, w in zip(np.concatenate([a_lo, a_hi]),
                           rng.uniform(16.9, 17.1, 10))]
    d_true = np.array([1.0 + 0.01 * (m["a0"] - 9) for m in mus])
    snaps = [_wave(100, 500, speed=1.0 / d) for d in d_true]
    law, dils = reg.fit_dilation_law(snaps, mus, features=("a0", "omega"),
                                     search=(0.9, 1.15))
    ref_law, ref_dils = ref_reg.fit_dilation_law(
        snaps, mus, features=("a0", "omega"), search=(0.9, 1.15))
    np.testing.assert_allclose(dils, ref_dils, rtol=0, atol=1e-10)
    _assert_laws_equal(law, ref_law)
    assert law.has_guard
    for m in mus:
        assert not bool(law.extrapolation_flag(m)), m
    assert not bool(law.extrapolation_flag(
        dict(a0=float(a_lo.mean()), omega=17.0, delta=0.12)))
    assert bool(law.extrapolation_flag(dict(a0=9.0, omega=17.0,
                                            delta=0.12)))
    assert bool(law.extrapolation_flag(dict(a0=11.0, omega=17.0,
                                            delta=0.12)))


# ---------------------------------------------------------------------------
# The registered fleet build (tests/test_registration.py:418-556)
# ---------------------------------------------------------------------------
def _cache_mus(workdir):
    with np.load(os.path.join(workdir, StorageNames.MULOCAL_SNAPSHOTS)) as d:
        keys = [str(k) for k in d["mu_keys"]]
        return keys, [np.asarray(d[f"mus_{c}"]) for c in range(2)]


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """Both packages' registered fleets at the reference fixture's
    settings, each in its pipeline's own directory (the N-MDEIM restore
    reads the box-wide pickle there); the trajectory caches written so
    the training μ can be compared."""
    ref_dir = tmp_path_factory.mktemp("ref_registered")
    ref = build_piston_hrom(ref_dir)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp.linalg, "svd", _numpy_svd)
        mp.chdir(ref_dir)
        ref_ml = ref.build_mulocal_serving(rnd=np.random.RandomState(2),
                                           dump=False, snapshot_cache=True,
                                           **REGISTERED)
    port_dir = tmp_path_factory.mktemp("port_registered")
    port = port_build(port_dir)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(port_dir)
        port_ml = port.build_mulocal_serving(rnd=np.random.RandomState(2),
                                             dump=False, snapshot_cache=True,
                                             **REGISTERED)
    return dict(ref=ref, ref_ml=ref_ml, ref_dir=ref_dir, port=port,
                port_ml=port_ml, port_dir=port_dir)


def _projector_gap(a, b):
    return max(float(np.abs(Va @ Va.T - Vb @ Vb.T).max())
               for Va, Vb in zip(np.asarray(a), np.asarray(b)))


def test_registered_fleet_build(builds):
    """Cell 0 unregistered, cell 1 registered with the reference's law:
    the same training μ in the same order, the law's names, coefficients
    and guard, the training dilations (its predictions at the training
    μ), and window bases of the same span."""
    ml, ref_ml = builds["port_ml"], builds["ref_ml"]
    assert ml.cells[0].dilation is None and ref_ml.cells[0].dilation is None
    law, ref_law = ml.cells[1].dilation, ref_ml.cells[1].dilation
    assert law is not None
    assert set(law.names) <= {"a0", "omega", "delta", "alpha", "gamma"}
    assert np.isfinite(law.coef).all()
    _assert_laws_equal(law, ref_law)

    keys, mus = _cache_mus(builds["port_dir"])
    ref_keys, ref_mus = _cache_mus(builds["ref_dir"])
    assert keys == ref_keys
    for got, want in zip(mus, ref_mus):
        np.testing.assert_array_equal(got, want)
    port = builds["port"]
    assert [[float(m[k]) for k in keys] for m in port.cell_mus[1]] \
        == mus[1].tolist()
    assert set(port.cell_dilations) == {1}
    want_dils = [ref_law.predict(dict(zip(keys, row))) for row in ref_mus[1]]
    np.testing.assert_allclose(port.cell_dilations[1], want_dils, rtol=0,
                               atol=1e-10)
    assert (port.cell_dilations[1] >= 1.01 - 1e-12).all()
    np.testing.assert_array_equal(ml.edges, ref_ml.edges)
    for got, want in zip(ml.cells, ref_ml.cells):
        assert got.Vs.shape == np.asarray(want.Vs).shape
        assert _projector_gap(got.Vs, want.Vs) <= 1e-8
    fleet_secs = port.fleet_seconds
    assert fleet_secs["registered_resolves"] > 0 and fleet_secs["law_fit"] > 0


def test_registered_routing_and_accuracy(builds):
    """The routed mixed fleet (float64, engine="windowed", mode="full"):
    the unregistered lane on d = 1, the registered one dilated; each
    within 4e-3 of the port's float64 FOM on its matched (dilated) grid,
    the registered lane resampled to the standard clock within 2e-2 of
    the standard-grid FOM (tests/test_registration.py:447-500); the
    trajectories within 1e-9·scale of the reference's route."""
    port, ml = builds["port"], builds["port_ml"]
    rom = port.rom
    prev = rom.mulocal
    rom.mulocal = ml
    try:
        with compute_dtype_scope(torch.float64):
            outs = rom.solve_batch_mulocal([dict(MU_LO), dict(MU_HI)],
                                           step=Stage.VALIDATION,
                                           mode="full", engine="windowed")
    finally:
        rom.mulocal = prev
    dils = np.asarray(outs["dil"], np.float64)
    assert dils[0] == 1.0 and dils[1] > 1.0

    ref = builds["ref"]
    ref_rom = ref.rom
    ref_prev = ref_rom.mulocal
    ref_rom.mulocal = builds["ref_ml"]
    try:
        want = ref_rom.solve_batch_mulocal([dict(MU_LO), dict(MU_HI)],
                                           step=RefStage.VALIDATION,
                                           mode="full", engine="windowed")
    finally:
        ref_rom.mulocal = ref_prev
        ref_rom._online_fns = {}
    np.testing.assert_array_equal(dils, np.asarray(want["dil"]))
    for k in ("uc", "x", "t"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(outs[k], w, rtol=0,
                                   atol=1e-9 * np.abs(w).max(), err_msg=k)

    fom = port.fom
    t_orig = fom.domain[fom.T]
    with compute_dtype_scope(torch.float64):
        for i, m in enumerate((MU_LO, MU_HI)):
            try:
                fom.domain[fom.T] = float(t_orig) * float(dils[i])
                fom.setup()
                fom.update_parametrization(m)
                fom.solve()
                matched = np.asarray(fom.solutions.fom)
            finally:
                fom.domain[fom.T] = t_orig
            u = np.asarray(outs["uc"][i]).T
            rel = np.linalg.norm(u - matched) / np.linalg.norm(matched)
            assert rel < 4e-3, (i, rel)
        fom.setup()
        fom.update_parametrization(MU_HI)
        fom.solve()
        ref_std = np.asarray(fom.solutions.fom)
    u_std = reg.resample_to_standard(np.asarray(outs["uc"][1]),
                                     float(dils[1]), axis=0).T
    rel_std = np.linalg.norm(u_std - ref_std) / np.linalg.norm(ref_std)
    assert rel_std < 2e-2, rel_std


def test_registered_mulocal_npz_roundtrip(builds, tmp_path):
    """Each package loads the other's registered fleet npz with the law
    and its guard intact (tests/test_registration.py:503-515)."""
    ml, ref_ml = builds["port_ml"], builds["ref_ml"]
    mu = dict(MU_HI)
    port_path, ref_path = tmp_path / "port.npz", tmp_path / "ref.npz"
    ml.dump(port_path)
    ref_ml.dump(ref_path)
    for back, law0 in ((RefMuLocalWindowed.load(port_path),
                        ml.cells[1].dilation),
                       (MuLocalWindowed.load(port_path),
                        ml.cells[1].dilation),
                       (MuLocalWindowed.load(ref_path),
                        ref_ml.cells[1].dilation)):
        assert back.cells[0].dilation is None
        law = back.cells[1].dilation
        assert law.names == law0.names
        np.testing.assert_array_equal(law.coef, law0.coef)
        np.testing.assert_array_equal(law.guard_feats, law0.guard_feats)
        assert law.predict(mu) == law0.predict(mu)
    got = MuLocalWindowed.load(ref_path)
    for a, b in zip(got.cells, ref_ml.cells):
        np.testing.assert_array_equal(a.Vs, b.Vs)
        for k in b.combines:
            np.testing.assert_array_equal(a.combines[k], b.combines[k])


def test_register_auto_skips_unalignable_cells(builds, monkeypatch):
    """register="auto": a cell whose alignment search hits the boundary
    builds unregistered; an explicit list still raises
    (tests/test_registration.py:518-556)."""
    port = builds["port"]

    def always_boundary(*a, **k):
        raise ValueError("dilation search ... hit the boundary")

    monkeypatch.setattr(reg, "fit_dilation_law", always_boundary)
    monkeypatch.chdir(builds["port_dir"])
    prev, prev_windows = port.rom.mulocal, port.rom.windows
    try:
        ml = port.build_mulocal_serving(
            n_cells=2, n_windows=4, num_basis=12, snapshots_per_cell=2,
            rnd=np.random.RandomState(5), register="auto", dump=False,
            snapshot_cache=False)
        assert all(w.dilation is None for w in ml.cells)
        with pytest.raises(ValueError, match="boundary"):
            port.build_mulocal_serving(
                n_cells=2, n_windows=4, num_basis=12, snapshots_per_cell=2,
                rnd=np.random.RandomState(5), register=[0, 1], dump=False,
                snapshot_cache=False)
        assert port.rom.windows is prev_windows
    finally:
        port.rom.mulocal = prev


def test_optimal_dilation_matches_the_plain_search():
    """The search's time-major error evaluation returns the plain
    evaluation's d bit for bit: ‖resample_time(u[::s], d) − a[::s]‖ on the
    reference's coarse and refine grids (rom/registration.py:180-205)."""
    def plain(u, anchor, lo, hi, coarse=161, refine=33, stride=8):
        u, anchor = u[::stride], anchor[::stride]

        def err(d):
            return float(np.linalg.norm(reg.resample_time(u, d) - anchor))

        grid = np.linspace(lo, hi, coarse)
        d0 = grid[int(np.argmin([err(d) for d in grid]))]
        step = grid[1] - grid[0]
        fine = np.linspace(d0 - step, d0 + step, refine)
        return float(fine[int(np.argmin([err(d) for d in fine]))])

    rng = np.random.default_rng(3)
    anchor = _wave(90, 700, speed=1.0) + 1e-3 * rng.standard_normal((90, 700))
    for speed in (0.9, 1.0, 1.07):
        u = _wave(90, 700, speed=speed) + 1e-3 * rng.standard_normal(
            (90, 700))
        assert reg.optimal_dilation(u, anchor, lo=0.82, hi=1.22) == plain(
            u, anchor, 0.82, 1.22)
    u, a = rng.standard_normal((37, 211)), rng.standard_normal((37, 211))
    assert reg.optimal_dilation(u, a) == plain(u, a, 0.9, 1.1)
