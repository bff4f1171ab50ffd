"""The port's serving slice end to end against the JAX reference, on a
real JAX-built piston cell (the small windowed pipeline of
tests/conftest.py: nx=150, nt=96, W=4 windows of N=12).

The reference serves through ``solve_batch(mode="probes",
engine="windowed-pallas")`` in f32 with its kernels in interpret mode
(tests/test_windowed.py:97-125 setup); the port serves the same
configuration carried across as numpy (romtime_tpu_torch.convert), its
kernel twins on the CPU. Each stage-2 branch is compared: the
materialized one under the default precompute budget (K2), and with the
budget at 0 the fused K1 and the v2 per-window K3. Tolerances are the
reference test's: probes 5e-6·scale, uN_final 5e-5; the prep tables
match to 1e-5 of each θ row's max (f32 assembly in a different op
order)."""

import numpy as np
import pytest
import torch

from romtime_tpu.conventions import StorageNames
from romtime_tpu.rom.registration import DilationLaw as RefDilationLaw
from romtime_tpu.rom.windowed import WindowedServing as RefWindowedServing
from romtime_tpu_torch import serving_from_arrays, serving_to_arrays
from romtime_tpu_torch.rom.registration import DilationLaw
from romtime_tpu_torch.rom.windowed import WindowedServing
from torch_parity import (
    BRANCHES,
    assert_served_close,
    build_piston_hrom,
    clear_serving_caches,
    payload_from_rom,
    piston_mus,
    port_branch,
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


@pytest.fixture(scope="module")
def piston_cell(tmp_path_factory):
    """The conftest windowed piston pipeline, built with the POD's SVD
    routed through numpy (torch_parity.build_piston_hrom)."""
    rom = build_piston_hrom(tmp_path_factory.mktemp("torch_piston")).rom
    return rom, payload_from_rom(rom)


@pytest.fixture
def registered(piston_cell):
    """The same law attached to both sides (reference and port)."""
    rom, payload = piston_cell
    port = serving_from_arrays(payload, device="cpu")
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


def test_tables_match_reference(piston_cell):
    """Stacked per-window constants: same layouts, identical values."""
    rom, payload = piston_cell
    port = serving_from_arrays(payload, device="cpu")
    ref_tables, _ = reference_prep(rom, piston_mus(4))
    tables = port._windowed_tables()
    for key in ("Bmk", "BmF", "BkF", "BfT", "TQ", "VE", "Tp"):
        np.testing.assert_array_equal(tables[key].numpy(), ref_tables[key],
                                      err_msg=key)
    assert (tables["km8"], tables["kk8"], tables["kf8"]) == (
        ref_tables["Bm"].shape[2], ref_tables["Bk"].shape[2],
        ref_tables["Bf"].shape[2])


def test_prep_tables_match_reference(piston_cell):
    rom, payload = piston_cell
    mus = piston_mus(16, seed=1)
    _, ref = reference_prep(rom, mus)
    port = serving_from_arrays(payload, device="cpu")
    got = {k: v.numpy() for k, v in port.prep(mus).items()}
    assert set(got) == set(ref)
    for key in ("THm", "THk", "THf", "g"):
        _assert_rows_close(got[key], ref[key], key)
    np.testing.assert_allclose(got["b0"], ref["b0"], rtol=1e-6)


def test_solve_batch_matches_reference(piston_cell):
    """The slice end to end: 128 distinct μ through the reference's
    windowed serving and through the port's solve_batch, both under the
    default precompute budget (the materialized branch, K2)."""
    rom, payload = piston_cell
    mus = piston_mus(128, seed=2)
    ref = reference_solve(rom, mus)
    got = serving_from_arrays(payload, device="cpu").solve_batch(
        mus, mode="probes")
    assert set(got) == set(ref)
    np.testing.assert_allclose(got["t"], ref["t"], rtol=1e-6)
    assert_served_close(got, ref)


@pytest.mark.parametrize("branch", ["fused", "v2"])
def test_solve_batch_branch_matches_reference(piston_cell, monkeypatch,
                                              branch):
    """The θ-streaming branches (precompute budget 0 on both sides): the
    fused K1, and v2 with a K3 launch per window."""
    rom, payload = piston_cell
    mus = piston_mus(128, seed=10)
    port = port_branch(serving_from_arrays(payload, device="cpu"), branch,
                       monkeypatch)
    got = port.solve_batch(mus, mode="probes")
    ref = reference_solve(rom, mus, branch=branch)
    assert set(got) == set(ref)
    assert_served_close(got, ref)


#: (B, budget, ROMTIME_WINDOWED_KERNEL, branch) on the parity cell
#: (nt=96, NP=16): the tables of B lanes take 2·96·16²·B·4 bytes.
ROUTES = [(16, None, None, "matrices"), (16, 0, None, "fused"),
          (16, 0, "fused", "fused"), (16, 0, "v2", "v2"),
          (16, 0, "other", "v2"), (16, 3145728, "v2", "matrices"),
          (16, 3145727, None, "fused"), (17, 3145728, None, "fused")]


@pytest.mark.parametrize("B,budget,env,branch", ROUTES)
def test_stage2_routing(piston_cell, monkeypatch, B, budget, env, branch):
    """solve_batch calls the sweep of the reference's branch for (B,
    budget, ROMTIME_WINDOWED_KERNEL), seen through spies on the engine
    module."""
    from romtime_tpu_torch.rom.engines import windowed_fused as engine

    _rom, payload = piston_cell
    port = serving_from_arrays(payload, device="cpu")
    if budget is not None:
        port.ONLINE_PRECOMPUTE_BUDGET = budget
    if env is None:
        monkeypatch.delenv("ROMTIME_WINDOWED_KERNEL", raising=False)
    else:
        monkeypatch.setenv("ROMTIME_WINDOWED_KERNEL", env)
    calls = []

    def spy(name):
        def sweep(fom, win, prepped, tables, *_solve):
            calls.append(name)
            nt, _k, b = prepped["THm"].shape
            NP = tables["VE"].shape[2]
            return torch.zeros((nt, 8, b)), torch.zeros((4, NP, b))
        return sweep

    for name in BRANCHES:
        attr = {"matrices": "sweep_materialized", "fused": "sweep_fused",
                "v2": "sweep_theta_v2"}[name]
        monkeypatch.setattr(engine, attr, spy(name))
    out = port.solve_batch(piston_mus(B, seed=11), mode="probes")
    assert calls == [branch]
    assert out["probes"].shape == (B, 96, 2)


def test_fleet_shape_routing():
    """At the 50x32 fleet shape (nt=1500, NP=32) the reference's 6 GiB
    budget takes B=512 to the materialized tables and B=1024 to θ."""
    from romtime_tpu_torch.rom.engines.policy import PrecomputePolicy
    from romtime_tpu_torch.rom.engines.windowed_fused import stage2_branch

    choose = PrecomputePolicy().precompute_choice
    assert stage2_branch(1500, 32, 512, choose) == "matrices"
    assert stage2_branch(1500, 32, 1024, choose) == "fused"
    assert PrecomputePolicy.ONLINE_PRECOMPUTE_BUDGET == 6 * 1024**3


def test_default_device_is_the_card(piston_cell):
    """Without device=, serving runs on the card: with none, it fails
    loudly instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _rom, payload = piston_cell
    port = serving_from_arrays(payload)
    assert port.device == torch.device("cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        port.solve_batch(piston_mus(2), mode="probes")


def test_registered_prep_matches_reference(registered):
    rom, port = registered
    mus = piston_mus(32, seed=3)
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
    mus = piston_mus(128, seed=4)
    with torch.no_grad():
        got = port.solve_batch(mus, mode="probes")
    ref = reference_solve(rom, mus)
    assert set(got) == set(ref)
    np.testing.assert_allclose(got["dil"], ref["dil"], rtol=1e-6)
    np.testing.assert_array_equal(got["dil_oor"], ref["dil_oor"])
    np.testing.assert_allclose(got["t"], ref["t"], rtol=1e-6)
    assert_served_close(got, ref)


def test_probe_reduce(piston_cell):
    _rom, payload = piston_cell
    port = serving_from_arrays(payload, device="cpu")
    mus = piston_mus(8, seed=5)
    full = port.solve_batch(mus, mode="probes")["probes"]    # (B, nt, 2)
    mean = port.solve_batch(mus, mode="probes",
                            probe_reduce="mean")["probes"]
    # f32 time average in another summation order than numpy's.
    np.testing.assert_allclose(mean, full.mean(axis=1), rtol=0,
                               atol=1e-6 * np.abs(full).max())
    every3 = port.solve_batch(mus, mode="probes", probe_reduce=3)["probes"]
    np.testing.assert_array_equal(every3, full[:, 2::3])
    with pytest.raises(ValueError):
        port.solve_batch(mus, mode="probes", probe_reduce="max")


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
    back = serving_to_arrays(serving_from_arrays(payload, device="cpu"))
    assert set(back) == set(payload)
    for key in payload:
        np.testing.assert_array_equal(back[key], payload[key], err_msg=key)


def test_empty_entries_raise(piston_cell):
    """An empty entry list raises: serving never falls back to the full
    band (the reference's ``if entries:`` would). ``entries=None`` is the
    full band, as in the reference: the lifting vector of a one-lane μ
    batch equals the reference's, float64 on both sides."""
    import jax.numpy as jnp

    rom, payload = piston_cell
    fom = serving_from_arrays(payload, device="cpu").fom
    mu = piston_mus(1)[0]
    f64 = torch.float64
    mu_t = {k: torch.tensor([v], dtype=f64) for k, v in mu.items()}
    t = torch.tensor(0.1, dtype=f64)
    with pytest.raises(ValueError, match="entry"):
        fom.assemble_mass(mu_t, t, entries=[])
    got = fom.assemble_rhs(mu_t, t, entries=None).numpy()
    want = np.asarray(rom.fom.assemble_rhs(
        {k: jnp.asarray(v) for k, v in mu.items()}, jnp.asarray(0.1)))
    assert got.shape == (fom.mesh.nh, 1) and want.shape == (fom.mesh.nh,)
    np.testing.assert_allclose(got[:, 0], want, rtol=1e-12,
                               atol=1e-14 * np.abs(want).max())


def _served_with_env(piston_cell, monkeypatch, env, value, seed):
    """The fused branch served by the port and by the reference under
    ``env=value`` (the LU schedule: ROMTIME_SOLVE_ITERS=0 on both
    sides), with a spy on the K1 wrapper the engine calls. Returns the
    solve keywords that reached it."""
    from romtime_tpu_torch.rom.engines import windowed_fused as engine

    rom, payload = piston_cell
    monkeypatch.setenv(env, value)
    monkeypatch.setenv("ROMTIME_SOLVE_ITERS", "0")
    seen = []
    wrapper = engine.online_sweep_windowed_fused

    def spy(*args, **kw):
        seen.append({k: kw[k] for k in ("paired_lu", "paired_mode",
                                        "solve_iters")})
        return wrapper(*args, **kw)

    monkeypatch.setattr(engine, "online_sweep_windowed_fused", spy)
    port = port_branch(serving_from_arrays(payload, device="cpu"), "fused",
                       monkeypatch)
    mus = piston_mus(128, seed=seed)
    got = port.solve_batch(mus, mode="probes")
    ref = reference_solve(rom, mus, branch="fused")
    assert set(got) == set(ref)
    assert_served_close(got, ref)
    assert len(seen) == 1
    return seen[0]


@pytest.mark.parametrize("env,value", [("ROMTIME_PAIRED_MODE", "inv1"),
                                       ("ROMTIME_PAIRED_MODE", "warm1")])
def test_unported_solver_options_raise(piston_cell, monkeypatch, env,
                                       value):
    """The follower modes (once refused here) serve: the fused branch
    under ROMTIME_PAIRED_MODE matches the reference under the same
    setting, and the mode reaches the K1 wrapper. The cell's N=12 runs
    the Gauss-Jordan solve, where both packages turn pairing off; the
    kernel-level tests (test_torch_follower_modes.py) carry the modes'
    numerics. The port opts into the paired schedule with
    ROMTIME_PAIRED_LU=5, the reference's default."""
    monkeypatch.setenv("ROMTIME_PAIRED_LU", "5")
    seen = _served_with_env(piston_cell, monkeypatch, env, value, seed=12)
    assert seen == {"paired_lu": 5, "paired_mode": value,
                    "solve_iters": None}


def test_paired_lu_zero_serves_per_step_lu(piston_cell, monkeypatch):
    """ROMTIME_PAIRED_LU=0 is the per-step LU in both packages (the
    port's own ROMTIME_PAIRED_MODE=off is gone: the reference read "off"
    as sub1 and paired)."""
    seen = _served_with_env(piston_cell, monkeypatch, "ROMTIME_PAIRED_LU",
                            "0", seed=13)
    assert seen == {"paired_lu": None, "paired_mode": "sub1",
                    "solve_iters": None}


def test_unknown_paired_mode_raises(piston_cell, monkeypatch):
    """An unknown ROMTIME_PAIRED_MODE raises and names the six modes,
    where the reference serves sub1 without a word."""
    _rom, payload = piston_cell
    monkeypatch.setenv("ROMTIME_PAIRED_MODE", "off")
    port = port_branch(serving_from_arrays(payload, device="cpu"), "fused",
                       monkeypatch)
    with pytest.raises(ValueError, match="sub1, warm1, warm2, warmx"):
        port.solve_batch(piston_mus(2), mode="probes")


def test_entry_assembly_matches_reference(piston_cell):
    """Every θ source's gathered DEIM-entry assembly at one (μ, t), in
    float64 on both sides."""
    import jax.numpy as jnp

    from romtime_tpu_torch.dtypes import compute_dtype_scope

    rom, payload = piston_cell
    port = serving_from_arrays(payload, device="cpu")
    mu = piston_mus(1, seed=6)[0]
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
    port = serving_from_arrays(payload, device="cpu")
    red = MatrixDiscreteEmpiricalInterpolationNonlinear(
        assemble=port.fom.assemble_trilinear, dofs=ref_red.dofs)
    mu = piston_mus(1, seed=8)[0]
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

    mus = piston_mus(64, seed=9)
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
    port = serving_from_arrays(payload, device="cpu")
    mu = piston_mus(1, seed=7)[0]
    assert port.compute_piston_mach_number(mu) == \
        Ref.compute_piston_mach_number(mu)


def test_synthetic_cell_serves_and_round_trips():
    """The seeded synthetic cell that chip_smoke.py serves on the card, at
    a CPU size: finite outputs of the served shapes, the pivot-free guard
    skipped (the cell carries no global basis, as the reference skips
    it), and identical serving after a trip through the payload."""
    from romtime_tpu_torch.testing.synthetic import (
        synthetic_cell,
        synthetic_mus,
    )

    rom = synthetic_cell(seed=3, nx=100, nt=60, n_windows=2, N=24, k=4,
                         device="cpu")
    mus = synthetic_mus(8, seed=4)
    out = rom.solve_batch(mus, mode="probes", probe_reduce="mean")
    assert out["probes"].shape == (8, 2) and out["uN_final"].shape == (8, 24)
    assert np.isfinite(out["probes"]).all()
    assert np.isfinite(out["uN_final"]).all()
    assert rom.global_serving is None and rom._pivot_cert is None
    again = serving_from_arrays(serving_to_arrays(rom),
                                device="cpu").solve_batch(
        mus, mode="probes", probe_reduce="mean")
    for key in out:
        np.testing.assert_array_equal(again[key], out[key])
