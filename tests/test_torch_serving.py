"""The port's serving slice end to end against the JAX reference, on a
real JAX-built piston cell (the small windowed pipeline of
tests/conftest.py: nx=150, nt=96, W=4 windows of N=12).

The reference serves through ``solve_batch(mode="probes",
engine="windowed-pallas")`` in f32 with the fused kernel in interpret
mode (tests/test_windowed.py:97-125 setup); the port serves the same
configuration carried across as numpy (romtime_tpu_torch.convert), its
K1 twin on the CPU. Tolerances are the reference test's: probes
5e-6·scale, uN_final 5e-5; the prep tables match to 1e-5 of each θ row's
max (f32 assembly in a different op order)."""

import numpy as np
import pytest
import torch

from conftest import _piston_windowed_setup
from romtime_tpu.conventions import StorageNames
from romtime_tpu.rom.registration import DilationLaw as RefDilationLaw
from romtime_tpu.rom.windowed import WindowedServing as RefWindowedServing
from romtime_tpu_torch import serving_from_arrays, serving_to_arrays
from romtime_tpu_torch.rom.registration import DilationLaw
from romtime_tpu_torch.rom.windowed import WindowedServing
from torch_parity import (
    clear_serving_caches,
    payload_from_rom,
    reference_prep,
    reference_solve,
)

#: A guarded law (the a0 cluster of
#: test_registration.test_dilation_guard_flag_in_serving_output): lanes
#: with a0 beyond ~[8.8, 9.6] are flagged as extrapolating.
LAW_PAYLOAD = dict(
    names=np.array(["a0"]), coef=np.array([1.0 - 0.004 * 9.3, 0.004]),
    floor=np.float64(1.0),
    guard_feats=np.array([[9.0], [9.2], [9.4]]) / 0.4,
    guard_inv_span=np.array([1.0 / 0.4]), guard_dref=np.float64(0.5),
)


def _numpy_svd(a, full_matrices=False):
    return tuple(np.linalg.svd(np.asarray(a), full_matrices=full_matrices))


@pytest.fixture(scope="module")
def piston_cell(tmp_path_factory):
    """The conftest windowed piston pipeline, built with the POD's SVD
    routed through numpy: the jax CPU SVD returns NaN spectra on some
    exactly-rank-1 snapshot matrices (ROADMAP Queue 3), which leaves an
    MDEIM without dofs."""
    import jax.numpy as jnp

    from romtime_tpu.conventions import Stage
    from romtime_tpu.rom.hrom import HyperReducedPiston

    workdir = tmp_path_factory.mktemp("torch_piston")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp.linalg, "svd", _numpy_svd)
        mp.chdir(workdir)
        hrom = HyperReducedPiston(**_piston_windowed_setup(),
                                  rnd=np.random.RandomState(0))
        hrom.setup()
        hrom.setup_hyperreduction()
        hrom.run_offline_rom()
        hrom.run_offline_hyperreduction(
            mu_space=hrom.mu_space[Stage.OFFLINE], evaluate=False)
        hrom.project_reductors()
        hrom.build_windowed_serving(n_windows=4, num_basis=12,
                                    srom_extra=4)
    rom = hrom.rom
    for name, (red, _fb) in rom._theta_sources().items():
        assert red.dofs, f"reference {name} reductor has no dofs"
    payload = payload_from_rom(rom)
    return rom, payload


def _mus(B, seed=0):
    rng = np.random.default_rng(seed)
    return [dict(a0=rng.uniform(8.0, 10.0), omega=rng.uniform(15.0, 20.0),
                 delta=rng.uniform(0.1, 0.15), alpha=1e-6, gamma=1.4)
            for _ in range(B)]


@pytest.fixture
def registered(piston_cell):
    """The same law attached to both sides (reference and port)."""
    rom, payload = piston_cell
    port = serving_from_arrays(payload)
    ref_law = RefDilationLaw.from_payload(**LAW_PAYLOAD)
    port.windows.dilation = DilationLaw.from_payload(**LAW_PAYLOAD)
    port._set_serving_windows(port.windows)
    rom.windows.dilation = ref_law
    clear_serving_caches(rom)
    try:
        yield rom, port
    finally:
        rom.windows.dilation = None
        clear_serving_caches(rom)


def _assert_rows_close(got, want, name, rtol=1e-5):
    """Per θ row k: |got − want| ≤ rtol · max|want[:, k, :]|."""
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = np.abs(want).max(axis=(0, 2), keepdims=True)
    err = np.abs(got - want)
    assert np.all(err <= rtol * scale + 1e-30), (
        name, float((err / np.maximum(scale, 1e-30)).max()))


def _assert_serving_close(got, ref):
    assert np.isfinite(ref["probes"]).all()
    assert np.isfinite(ref["uN_final"]).all()
    assert got["probes"].shape == ref["probes"].shape
    scale = max(np.abs(ref["probes"]).max(), 1e-3)
    np.testing.assert_allclose(got["probes"], ref["probes"], rtol=0,
                               atol=5e-6 * scale)
    np.testing.assert_allclose(got["uN_final"], ref["uN_final"], rtol=0,
                               atol=5e-5)


def test_tables_match_reference(piston_cell):
    """Stacked per-window constants: same layouts, identical values."""
    rom, payload = piston_cell
    port = serving_from_arrays(payload)
    ref_tables, _ = reference_prep(rom, _mus(4))
    tables = port._windowed_tables()
    for key in ("Bmk", "BmF", "BkF", "BfT", "TQ", "VE", "Tp"):
        np.testing.assert_array_equal(tables[key].numpy(), ref_tables[key],
                                      err_msg=key)
    assert (tables["km8"], tables["kk8"], tables["kf8"]) == (
        ref_tables["Bm"].shape[2], ref_tables["Bk"].shape[2],
        ref_tables["Bf"].shape[2])


def test_prep_tables_match_reference(piston_cell):
    rom, payload = piston_cell
    mus = _mus(16, seed=1)
    _, ref = reference_prep(rom, mus)
    got = {k: v.numpy() for k, v in serving_from_arrays(payload)
           .prep(mus).items()}
    assert set(got) == set(ref)
    for key in ("THm", "THk", "THf", "g"):
        _assert_rows_close(got[key], ref[key], key)
    np.testing.assert_allclose(got["b0"], ref["b0"], rtol=1e-6)


def test_solve_batch_matches_reference(piston_cell):
    """The slice end to end: 128 distinct μ through the reference's fused
    windowed serving and through the port's solve_batch."""
    rom, payload = piston_cell
    mus = _mus(128, seed=2)
    ref = reference_solve(rom, mus)
    got = serving_from_arrays(payload).solve_batch(mus)
    assert set(got) == set(ref)
    np.testing.assert_allclose(got["t"], ref["t"], rtol=1e-6)
    _assert_serving_close(got, ref)


def test_registered_prep_matches_reference(registered):
    rom, port = registered
    mus = _mus(32, seed=3)
    _, ref = reference_prep(rom, mus)
    got = {k: v.numpy() for k, v in port.prep(mus).items()}
    assert set(got) == set(ref) >= {"dil", "dil_oor"}
    np.testing.assert_allclose(got["dil"], ref["dil"], rtol=1e-6)
    np.testing.assert_array_equal(got["dil_oor"], ref["dil_oor"])
    assert 0 < got["dil_oor"].sum() < len(mus)   # both outcomes occur
    for key in ("THm", "THk", "THf", "g"):
        _assert_rows_close(got[key], ref[key], key)
    np.testing.assert_allclose(got["b0"], ref["b0"], rtol=1e-6)


def test_registered_solve_batch_matches_reference(registered):
    rom, port = registered
    mus = _mus(128, seed=4)
    with torch.no_grad():
        got = port.solve_batch(mus)
    ref = reference_solve(rom, mus)
    assert set(got) == set(ref)
    np.testing.assert_allclose(got["dil"], ref["dil"], rtol=1e-6)
    np.testing.assert_array_equal(got["dil_oor"], ref["dil_oor"])
    np.testing.assert_allclose(got["t"], ref["t"], rtol=1e-6)
    _assert_serving_close(got, ref)


def test_probe_reduce(piston_cell):
    _rom, payload = piston_cell
    port = serving_from_arrays(payload)
    mus = _mus(8, seed=5)
    full = port.solve_batch(mus)["probes"]                   # (B, nt, 2)
    mean = port.solve_batch(mus, probe_reduce="mean")["probes"]
    # f32 time average in another summation order than numpy's.
    np.testing.assert_allclose(mean, full.mean(axis=1), rtol=0,
                               atol=1e-6 * np.abs(full).max())
    every3 = port.solve_batch(mus, probe_reduce=3)["probes"]
    np.testing.assert_array_equal(every3, full[:, 2::3])
    with pytest.raises(ValueError):
        port.solve_batch(mus, probe_reduce="max")


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_npz_roundtrip(piston_cell, tmp_path, direction):
    """Each package reads the other's windowed serving npz bit-exactly
    (with a guarded dilation law on board)."""
    rom, payload = piston_cell
    src = RefWindowedServing(
        bounds=rom.windows.bounds, Vs=rom.windows.Vs,
        transfers=rom.windows.transfers, combines=rom.windows.combines,
        trilinear=rom.windows.trilinear,
        dilation=RefDilationLaw.from_payload(**LAW_PAYLOAD))
    path = tmp_path / StorageNames.WINDOWS
    if direction == "reference_to_port":
        src.dump(path)
        loaded = WindowedServing.load(path)
    else:
        WindowedServing.from_arrays(src_arrays(src)).dump(path)
        loaded = RefWindowedServing.load(path)
    for key in ("bounds", "Vs", "transfers", "trilinear"):
        np.testing.assert_array_equal(getattr(loaded, key),
                                      getattr(src, key))
    assert set(loaded.combines) == set(src.combines)
    for name in src.combines:
        np.testing.assert_array_equal(loaded.combines[name],
                                      src.combines[name])
    law, want = loaded.dilation, src.dilation
    assert tuple(law.names) == tuple(want.names)
    np.testing.assert_array_equal(law.coef, want.coef)
    np.testing.assert_array_equal(law.guard_feats, want.guard_feats)
    assert law.guard_dref == want.guard_dref and law.floor == want.floor


def src_arrays(ref_win):
    """The reference's npz payload as a dict (its dump, read back)."""
    import io

    buf = io.BytesIO()
    ref_win.dump(buf)
    buf.seek(0)
    with np.load(buf) as data:
        return {k: data[k] for k in data.files}


def test_payload_roundtrip(piston_cell):
    _rom, payload = piston_cell
    back = serving_to_arrays(serving_from_arrays(payload))
    assert set(back) == set(payload)
    for key in payload:
        np.testing.assert_array_equal(back[key], payload[key], err_msg=key)


def test_empty_entries_raise(piston_cell):
    """Serving never assembles the full band: an empty entry list
    raises (the reference would fall back to a banded operator)."""
    _rom, payload = piston_cell
    fom = serving_from_arrays(payload).fom
    mu = {k: torch.tensor([v]) for k, v in _mus(1)[0].items()}
    with pytest.raises(ValueError, match="entry"):
        fom.assemble_mass(mu, torch.tensor(0.1), entries=[])
    with pytest.raises(ValueError, match="entry"):
        fom.assemble_rhs(mu, torch.tensor(0.1), entries=None)


@pytest.mark.parametrize("env,value", [("ROMTIME_SOLVE_ITERS", "4"),
                                       ("ROMTIME_PAIRED_MODE", "warm1")])
def test_unported_solver_options_raise(piston_cell, monkeypatch, env,
                                       value):
    _rom, payload = piston_cell
    monkeypatch.setenv(env, value)
    with pytest.raises(NotImplementedError):
        serving_from_arrays(payload).solve_batch(_mus(2))


def test_entry_assembly_matches_reference(piston_cell):
    """Every θ source's gathered DEIM-entry assembly at one (μ, t), in
    float64 on both sides."""
    import jax.numpy as jnp

    from romtime_tpu_torch.dtypes import compute_dtype_scope

    rom, payload = piston_cell
    port = serving_from_arrays(payload)
    mu = _mus(1, seed=6)[0]
    t = 0.37
    ref_mu = {k: jnp.asarray(v) for k, v in mu.items()}
    with compute_dtype_scope(torch.float64):
        mu_t = {k: torch.tensor(v, dtype=torch.float64)
                for k, v in mu.items()}
        for name, red in port._theta_sources().items():
            ref_red = rom._theta_sources()[name][0]
            want = np.asarray(ref_red._entries_traced(ref_mu, jnp.asarray(t)))
            got = red._entries_traced(mu_t, torch.tensor(
                t, dtype=torch.float64)).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-12,
                                       atol=1e-14 * np.abs(want).max(),
                                       err_msg=name)


def test_trilinear_entries_match_reference(piston_cell):
    """N-MDEIM entries b0·u·u′·v at the reference's dofs for a dof-vector
    state, float64 on both sides."""
    import jax.numpy as jnp

    from romtime_tpu_torch.deim import (
        MatrixDiscreteEmpiricalInterpolationNonlinear,
    )
    from romtime_tpu_torch.dtypes import compute_dtype_scope

    rom, payload = piston_cell
    ref_red = rom.mdeim_Nh
    port = serving_from_arrays(payload)
    red = MatrixDiscreteEmpiricalInterpolationNonlinear(
        assemble=port.fom.assemble_trilinear, dofs=ref_red.dofs)
    mu = _mus(1, seed=8)[0]
    u = np.random.default_rng(8).normal(size=port.fom.mesh.nh)
    want = np.asarray(ref_red.assemble(
        mu={k: jnp.asarray(v) for k, v in mu.items()}, t=jnp.asarray(0.21),
        u_n=jnp.asarray(u), entries=ref_red.dofs))
    with compute_dtype_scope(torch.float64):
        got = red._entries_traced(
            {k: torch.tensor(v, dtype=torch.float64) for k, v in mu.items()},
            torch.tensor(0.21, dtype=torch.float64),
            u_n=torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-14 * np.abs(want).max())


def test_dilation_law_evaluation_matches_reference():
    """Law prediction, guard distance and flag on a μ batch, float64."""
    import jax.numpy as jnp

    mus = _mus(64, seed=9)
    names = ("a0", "delta*omega*a0^-1", "omega^2")
    payload = dict(LAW_PAYLOAD, names=np.array(names),
                   coef=np.array([0.9, 0.01, 0.3, -1e-4]),
                   guard_feats=np.random.default_rng(9).uniform(
                       0, 1, size=(5, 3)),
                   guard_inv_span=np.array([0.5, 20.0, 0.01]))
    ref, law = (RefDilationLaw.from_payload(**payload),
                DilationLaw.from_payload(**payload))
    mu_j = {k: jnp.asarray([m[k] for m in mus]) for k in mus[0]}
    mu_t = {k: torch.tensor([m[k] for m in mus], dtype=torch.float64)
            for k in mus[0]}
    np.testing.assert_allclose(law.predict(mu_t).numpy(),
                               np.asarray(ref.predict(mu_j)), rtol=1e-14)
    np.testing.assert_allclose(law.guard_distance(mu_t).numpy(),
                               np.asarray(ref.guard_distance(mu_j)),
                               rtol=1e-12)
    np.testing.assert_array_equal(law.extrapolation_flag(mu_t).numpy(),
                                  np.asarray(ref.extrapolation_flag(mu_j)))
    assert law.to_payload().keys() == ref.to_payload().keys()


def test_piston_mach_number(piston_cell):
    from romtime_tpu.rom.rom import RomConstructorNonlinear as Ref

    _rom, payload = piston_cell
    port = serving_from_arrays(payload)
    mu = _mus(1, seed=7)[0]
    assert port.compute_piston_mach_number(mu) == \
        Ref.compute_piston_mach_number(mu)


def test_synthetic_cell_serves_and_round_trips():
    """The seeded synthetic cell that chip_smoke.py serves on the card, at
    a CPU size: finite outputs of the served shapes, a passing pivot-free
    check, and identical serving after a trip through the payload."""
    from romtime_tpu_torch.testing.synthetic import (
        synthetic_cell,
        synthetic_mus,
    )

    rom = synthetic_cell(seed=3, nx=100, nt=60, n_windows=2, N=24, k=4)
    mus = synthetic_mus(8, seed=4)
    out = rom.solve_batch(mus, probe_reduce="mean")
    assert out["probes"].shape == (8, 2) and out["uN_final"].shape == (8, 24)
    assert np.isfinite(out["probes"]).all()
    assert np.isfinite(out["uN_final"]).all()
    assert rom._pivot_cert >= 1e-3
    again = serving_from_arrays(serving_to_arrays(rom)).solve_batch(
        mus, probe_reduce="mean")
    for key in out:
        np.testing.assert_array_equal(again[key], out[key])
