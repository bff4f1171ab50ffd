"""The port's windowed and μ-local builds (romtime_tpu_torch/rom/windowed.py
``build_windowed_basis``, ``predict_window_floor``,
``select_fleet_shapes``; rom/rom.py ``build_windowed_serving``; rom/hrom.py
``build_windowed_serving``, ``build_windowed_srom``,
``build_mulocal_serving``, ``auto_cell_wn``) against the JAX package's.

Each package builds the conftest piston pipeline (nx=150, nt=96) in its
own working directory (the reference's through
tests/torch_parity.build_piston_hrom, its SVD routed through numpy, with
its W=4, N=12 windows and their N=16 S-ROM; the port's through
tests/test_torch_offline_build.port_build, then the same windows), and
then the fleet at the reference fixture's settings (``piston_mulocal``,
tests/test_windowed.py:325: K=2, W=4, N=12, 2 μ a cell,
RandomState(1)), in float64. Both must give the same training μ in the
same order and the same edges; window bases of the same span
(‖VVᵀ − V′V′ᵀ‖ ≤ 1e-8: singular vectors carry arbitrary signs); the
port's float64 windowed lanes trajectories within 1e-9·scale of the
reference's; and each package reads the other's
``windowed_serving*.npz``, ``windowed_serving_mulocal.npz`` and
``mulocal_snapshots.npz``.

Anchors (tests/test_windowed.py): test_build_windowed_basis_invariants
(:24), test_windowed_resume_from_existing_basis (:147),
test_mulocal_build_invariants (:345), test_mulocal_tracks_fom (:391),
test_mulocal_snapshot_cache_rebuild (:422), test_mulocal_mixed_cell_wn
(:463), test_mulocal_snapshot_cache_precision_guard (:551),
test_mulocal_device_sweep_matches_serial (:682), test_select_fleet_shapes
(:848), test_auto_cell_wn_from_cache (:907); and the served K1's default
schedule (paired LU G=5, ``sub1``) on a built cell against the reference
kernel on the same schedule (tests/test_pallas_online.py:779's limit)."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romtime_tpu.conventions import Stage as RefStage
from romtime_tpu.rom.hrom import HyperReducedOrderModelFixed as RefHROM
from romtime_tpu.rom.windowed import MuLocalWindowed as RefMuLocalWindowed
from romtime_tpu.rom.windowed import WindowedServing as RefWindowedServing
from romtime_tpu.rom.windowed import (
    build_windowed_basis as ref_build_windowed_basis,
)
from romtime_tpu.rom.windowed import (
    predict_window_floor as ref_predict_window_floor,
)
from romtime_tpu.rom.windowed import (
    select_fleet_shapes as ref_select_fleet_shapes,
)
from romtime_tpu_torch.conventions import (
    Errors,
    RomParameters,
    Stage,
    StorageNames,
)
from romtime_tpu_torch.dtypes import compute_dtype_scope
from romtime_tpu_torch.ops.windowed_fused import step_roles
from romtime_tpu_torch.parallel import sweep as port_sweep
from romtime_tpu_torch.rom.hrom import HyperReducedPiston
from romtime_tpu_torch.rom.rom import RomConstructorNonlinear as RCN
from romtime_tpu_torch.rom.windowed import (
    MuLocalWindowed,
    WindowedServing,
    build_windowed_basis,
    predict_window_floor,
    select_fleet_shapes,
)
from test_torch_offline_build import port_build, port_setup
from torch_parity import _numpy_svd, build_piston_hrom

jax.config.update("jax_enable_x64", True)

#: tests/conftest.py:139's held-out μ and tests/test_windowed.py:365's
#: two μ, one in each Mach cell.
MU_VAL = dict(a0=9.3, omega=17.5, delta=0.12, alpha=1e-6, gamma=1.4)
MU_LO = dict(a0=9.8, omega=15.5, delta=0.10, alpha=1e-6, gamma=1.4)
MU_HI = dict(a0=8.1, omega=19.5, delta=0.148, alpha=1e-6, gamma=1.4)
#: tests/test_windowed.py:334's fleet.
FLEET = dict(n_cells=2, n_windows=4, num_basis=12, snapshots_per_cell=2)


def _projector_gap(a, b):
    """The largest |V_wV_wᵀ − V′_wV′_wᵀ| over windows."""
    return max(float(np.abs(Va @ Va.T - Vb @ Vb.T).max())
               for Va, Vb in zip(np.asarray(a), np.asarray(b)))


def _assert_same_fleet_layout(got, want):
    np.testing.assert_array_equal(got.edges, want.edges)
    assert got.cell_wn == [tuple(x) for x in want.cell_wn]
    for a, b in zip(got.cells, want.cells):
        np.testing.assert_array_equal(a.bounds, b.bounds)
        assert _projector_gap(a.Vs, b.Vs) <= 1e-8
        assert sorted(a.combines) == sorted(b.combines)


def _assert_same_arrays(got, want):
    """Two configurations (either package's) equal bit for bit."""
    np.testing.assert_array_equal(got.Vs, want.Vs)
    np.testing.assert_array_equal(got.transfers, want.transfers)
    np.testing.assert_array_equal(got.bounds, want.bounds)
    assert sorted(got.combines) == sorted(want.combines)
    for k in want.combines:
        np.testing.assert_array_equal(got.combines[k], want.combines[k])
    np.testing.assert_array_equal(got.trilinear, want.trilinear)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's pipeline with its windows and its fleet, dumped in
    its own directory (the fleet's trajectory cache and npz too)."""
    workdir = tmp_path_factory.mktemp("ref_fleet")
    hrom = build_piston_hrom(workdir)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp.linalg, "svd", _numpy_svd)
        mp.chdir(workdir)
        ml = hrom.build_mulocal_serving(rnd=np.random.RandomState(1),
                                        **FLEET)
    return hrom, ml, workdir


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The port's own pipeline, windows (srom_extra=4, as the conftest
    pipeline's) and fleet, dumped in its own directory."""
    workdir = tmp_path_factory.mktemp("port_fleet")
    hrom = port_build(workdir)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(workdir)
        hrom.build_windowed_serving(n_windows=4, num_basis=12, srom_extra=4)
        ml = hrom.build_mulocal_serving(rnd=np.random.RandomState(1),
                                        **FLEET)
    return hrom, ml, workdir


def _port_route(hrom, ml, mus):
    rom = hrom.rom
    prev = rom.mulocal
    rom.mulocal = ml
    try:
        with compute_dtype_scope(torch.float64):
            return rom.solve_batch_mulocal([dict(m) for m in mus],
                                           step=Stage.VALIDATION,
                                           mode="full", engine="windowed")
    finally:
        rom.mulocal = prev


def _ref_route(hrom, ml, mus):
    rom = hrom.rom
    prev = rom.mulocal
    rom.mulocal = ml
    try:
        return rom.solve_batch_mulocal([dict(m) for m in mus],
                                       step=RefStage.VALIDATION,
                                       mode="full", engine="windowed")
    finally:
        rom.mulocal = prev
        rom._online_fns = {}


def _assert_routes_close(got, want):
    for k in ("uc", "x", "t"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=1e-9 * np.abs(w).max(), err_msg=k)


# ---------------------------------------------------------------------------
# The window POD and the fleet shapes (host numpy)
# ---------------------------------------------------------------------------
def test_build_windowed_basis_invariants():
    rng = np.random.default_rng(0)
    nh, nt = 60, 64
    snaps = [np.linalg.qr(rng.normal(size=(nh, 16)))[0]
             @ rng.normal(size=(16, nt)) for _ in range(2)]
    bounds, Vs, transfers = build_windowed_basis(snaps, n_windows=4,
                                                 num_basis=8)
    assert bounds[0] == 0 and bounds[-1] == nt
    assert Vs.shape == (4, nh, 8)
    for V in Vs:
        np.testing.assert_allclose(V.T @ V, np.eye(8), atol=1e-12)
    assert transfers.shape == (3, 8, 8)
    np.testing.assert_allclose(transfers[0], Vs[1].T @ Vs[0], atol=1e-14)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp.linalg, "svd", _numpy_svd)
        ref_bounds, ref_Vs, _ = ref_build_windowed_basis(snaps, n_windows=4,
                                                         num_basis=8)
    np.testing.assert_array_equal(bounds, ref_bounds)
    assert _projector_gap(Vs, ref_Vs) <= 1e-8
    # One window: no transfers; a stack short of N raises, as in the
    # reference.
    _b, Vs1, T1 = build_windowed_basis(snaps, n_windows=1, num_basis=8)
    assert Vs1.shape == (1, nh, 8) and T1.shape == (0, 8, 8)
    with pytest.raises(ValueError, match="rank"):
        build_windowed_basis([s[:, :20] for s in snaps[:1]], n_windows=4,
                             num_basis=8)


def _synthetic_cell(rng, nh, nt, rank, decay, n_traj):
    """tests/test_windowed.py:860-870's cell of trajectories."""
    U = np.linalg.qr(rng.normal(size=(nh, rank)))[0]
    t = np.linspace(0.0, 1.0, nt)
    modes = np.stack([np.cos((k + 1) * np.pi * t) for k in range(rank)])
    sig = decay ** np.arange(rank)
    return [(U * (sig * (1.0 + 0.1 * rng.normal(size=rank)))) @ modes
            for _ in range(n_traj)]


def test_select_fleet_shapes():
    rng = np.random.default_rng(7)
    nh, nt = 120, 100
    cell_a = _synthetic_cell(rng, nh, nt, 30, 0.15, 3)
    cell_b = _synthetic_cell(rng, nh, nt, 60, 0.85, 3)
    candidates = [(10, 8), (5, 16)]
    target = 1e-6
    fa = {wn: predict_window_floor(cell_a, *wn) for wn in candidates}
    fb = {wn: predict_window_floor(cell_b, *wn) for wn in candidates}
    for wn in candidates:
        assert fa[wn] == pytest.approx(ref_predict_window_floor(cell_a, *wn),
                                       rel=1e-10)
        assert fb[wn] == pytest.approx(ref_predict_window_floor(cell_b, *wn),
                                       rel=1e-10)
    assert fa[(10, 8)] < target
    assert all(f > target for f in fb.values())
    assert predict_window_floor(cell_a[:1], 10, 30) == np.inf

    cell_wn, floors = select_fleet_shapes([cell_a, cell_b], candidates,
                                          target_floor=target)
    ref_wn, ref_floors = ref_select_fleet_shapes([cell_a, cell_b],
                                                 candidates,
                                                 target_floor=target)
    assert cell_wn == ref_wn
    np.testing.assert_allclose(floors, ref_floors, rtol=1e-10)
    assert cell_wn[0] == (10, 8)
    assert cell_wn[1] == min(candidates, key=lambda wn: fb[wn])
    assert floors[0] == fa[(10, 8)] and floors[1] == fb[cell_wn[1]]

    # The predicted floor is what the port's windowed build achieves.
    bounds, Vs, _ = build_windowed_basis(cell_a, 10, 8)
    s = cell_a[0]
    res = tot = 0.0
    for w in range(10):
        blk = s[:, int(bounds[w]):int(bounds[w + 1])]
        res += np.sum((blk - Vs[w] @ (Vs[w].T @ blk)) ** 2)
        tot += np.sum(blk**2)
    assert np.sqrt(res / tot) <= 1.05 * fa[(10, 8)] + 1e-12


def test_auto_cell_wn_from_cache(tmp_path):
    rng = np.random.default_rng(3)
    nh, nt = 80, 60
    cells = [_synthetic_cell(rng, nh, nt, 20, 0.1, 2),
             _synthetic_cell(rng, nh, nt, 50, 0.9, 3)]
    payload = {"edges": np.array([0.0, 0.2, 0.4]),
               "per_cell": np.array([2, 3]),
               "has_nl": np.asarray(False), "build": np.asarray("f64")}
    for c, snaps in enumerate(cells):
        for j, s in enumerate(snaps):
            payload[f"snap_{c}_{j}"] = s
    path = str(tmp_path / "mulocal_snapshots.npz")
    np.savez(path, **payload)

    candidates = [(6, 6), (3, 12)]
    cell_wn, floors = HyperReducedPiston.auto_cell_wn(
        None, candidates, target_floor=1e-6, path=path)
    ref_wn, ref_floors = RefHROM.auto_cell_wn(None, candidates,
                                              target_floor=1e-6, path=path)
    assert cell_wn == ref_wn
    np.testing.assert_allclose(floors, ref_floors, rtol=1e-10)
    assert len(cell_wn) == 2 and cell_wn[0] == (6, 6) and floors[0] < 1e-6
    exp1 = {wn: predict_window_floor(cells[1], *wn) for wn in candidates}
    assert cell_wn[1] == min(candidates, key=lambda wn: exp1[wn])

    with pytest.raises(FileNotFoundError):
        HyperReducedPiston.auto_cell_wn(None, candidates, 1e-6,
                                        path=str(tmp_path / "none.npz"))
    # The stale-cache guards.
    with pytest.raises(ValueError, match="holds 2 cells"):
        HyperReducedPiston.auto_cell_wn(None, candidates, 1e-6, path=path,
                                        expect_n_cells=3)
    with pytest.raises(ValueError, match="edges"):
        HyperReducedPiston.auto_cell_wn(None, candidates, 1e-6, path=path,
                                        expect_edges=[0.0, 0.1, 0.4])
    assert HyperReducedPiston.auto_cell_wn(
        None, candidates, 1e-6, path=path, expect_n_cells=2,
        expect_edges=[0.0, 0.2, 0.4]) == (cell_wn, floors)


# ---------------------------------------------------------------------------
# The windowed build on the piston pipeline
# ---------------------------------------------------------------------------
def test_windowed_build_matches_reference(ref, port):
    """The port's windows and nested S-ROM windows span the reference's;
    the npz files cross both ways bit for bit; the port's float64 lanes
    trajectories meet the reference's."""
    ref_hrom, _ml, ref_dir = ref
    hrom, _pml, port_dir = port
    for got, want in ((hrom.rom.windows, ref_hrom.rom.windows),
                      (hrom.windows_srom, ref_hrom.windows_srom)):
        assert got.Vs.shape == np.asarray(want.Vs).shape
        np.testing.assert_array_equal(got.bounds, want.bounds)
        assert _projector_gap(got.Vs, want.Vs) <= 1e-8
        assert sorted(got.combines) == sorted(want.combines)
    np.testing.assert_array_equal(hrom.rom.windows.Vs,
                                  hrom.windows_srom.Vs[:, :, :12])
    for name in (StorageNames.WINDOWS, StorageNames.WINDOWS_SROM):
        _assert_same_arrays(WindowedServing.load(os.path.join(ref_dir, name)),
                            RefWindowedServing.load(os.path.join(ref_dir,
                                                                 name)))
        _assert_same_arrays(RefWindowedServing.load(os.path.join(port_dir,
                                                                 name)),
                            WindowedServing.load(os.path.join(port_dir,
                                                              name)))
    _assert_same_arrays(WindowedServing.load(
        os.path.join(port_dir, StorageNames.WINDOWS)), hrom.rom.windows)

    with compute_dtype_scope(torch.float64):
        got = hrom.rom.solve_batch([dict(MU_VAL)], step=Stage.VALIDATION,
                                   mode="full", engine="windowed")
    want = ref_hrom.rom.solve_batch([dict(MU_VAL)], step=RefStage.VALIDATION,
                                    mode="full", engine="windowed")
    ref_hrom.rom._online_fns = {}
    _assert_routes_close(got, want)


def test_windowed_resume_from_existing_basis(port, monkeypatch):
    """A fresh driver resumes the port's working directory with its
    windows serving-ready, and serves as the original
    (tests/test_windowed.py:147-176); ``build_windowed_srom`` retrofits
    the S-ROM windows and keeps the serving ones."""
    hrom, _ml, workdir = port
    monkeypatch.chdir(workdir)
    setup = port_setup()
    setup["rom_params"][RomParameters.SROM_KEEP] = hrom.srom.N
    fresh = HyperReducedPiston(**setup)
    fresh.setup()
    fresh.setup_hyperreduction()
    fresh.start_from_existing_basis()
    fresh.project_reductors()
    assert fresh.rom.windows.n_windows == hrom.rom.windows.n_windows
    np.testing.assert_array_equal(fresh.rom.windows.Vs, hrom.rom.windows.Vs)
    with compute_dtype_scope(torch.float64):
        outs = [r.solve_batch([dict(MU_VAL)], step=Stage.VALIDATION,
                              mode="full", engine="windowed")
                for r in (hrom.rom, fresh.rom)]
    np.testing.assert_allclose(outs[1]["uc"], outs[0]["uc"], rtol=0,
                               atol=1e-12)

    serving = fresh.rom.windows
    srom = fresh.build_windowed_srom(n_windows=4, num_basis=16, dump=False)
    assert fresh.rom.windows is serving
    np.testing.assert_array_equal(srom.Vs, hrom.windows_srom.Vs)


# ---------------------------------------------------------------------------
# The μ-local fleet
# ---------------------------------------------------------------------------
def test_mulocal_build_invariants(ref, port):
    """The same edges and training μ as the reference, in order (both
    caches' ``mus_{c}``), window bases of the same span, the fleet
    attached (tests/test_windowed.py:345-352)."""
    ref_hrom, ref_ml, ref_dir = ref
    hrom, ml, port_dir = port
    assert ml.n_cells == 2 and len(ml.edges) == 3
    assert all(w.n_windows == 4 and w.N == 12 for w in ml.cells)
    assert ml.cell_of(0.0) == 0 and ml.cell_of(99.0) == 1
    assert hrom.rom.mulocal is ml
    _assert_same_fleet_layout(ml, ref_ml)
    with np.load(os.path.join(port_dir, StorageNames.MULOCAL_SNAPSHOTS)) as d, \
            np.load(os.path.join(ref_dir,
                                 StorageNames.MULOCAL_SNAPSHOTS)) as r:
        assert sorted(d.files) == sorted(r.files)
        for k in ("edges", "per_cell", "has_nl", "build", "sampling",
                  "mu_keys", "mus_0", "mus_1"):
            np.testing.assert_array_equal(d[k], r[k], err_msg=k)
        assert str(d["build"]) == "f64"
        keys = [str(k) for k in d["mu_keys"]]
        for c in range(2):
            assert [[float(m[k]) for k in keys]
                    for m in hrom.cell_mus[c]] == d[f"mus_{c}"].tolist()
            for j in range(2):
                w = r[f"snap_{c}_{j}"]
                np.testing.assert_allclose(d[f"snap_{c}_{j}"], w, rtol=0,
                                           atol=1e-10 * np.abs(w).max())
    secs = hrom.fleet_seconds
    assert secs["training_sweep"] > 0 and secs["window_projection"] > 0
    assert secs["registered_resolves"] == 0.0


def test_mulocal_tracks_fom(ref, port):
    """The routed fleet within 1e-3 of the port's float64 FOM at the
    held-out μ (tests/test_windowed.py:391-398), and within 1e-9·scale
    of the reference's route on μ in both cells."""
    ref_hrom, ref_ml, _rd = ref
    hrom, ml, _pd = port
    mus = [MU_VAL, MU_LO, MU_HI]
    got = _port_route(hrom, ml, mus)
    _assert_routes_close(got, _ref_route(ref_hrom, ref_ml, mus))
    fom = hrom.fom
    with compute_dtype_scope(torch.float64):
        fom.setup()
        fom.update_parametrization(MU_VAL)
        fom.solve()
    uh_fom = np.asarray(fom.solutions.fom)
    u = np.asarray(got["uc"][0]).T
    rel = np.linalg.norm(u - uh_fom) / np.linalg.norm(uh_fom)
    assert rel < 1e-3, rel


def test_mulocal_npz_both_ways(ref, port, tmp_path):
    """Each package loads the other's fleet npz bit for bit; the port
    builds from the reference's trajectory cache with the FOM made
    unreachable, the reference's ``auto_cell_wn`` reads the port's."""
    ref_hrom, ref_ml, ref_dir = ref
    hrom, ml, port_dir = port
    name = StorageNames.WINDOWS_MULOCAL
    for got, want in ((MuLocalWindowed.load(os.path.join(ref_dir, name)),
                       ref_ml),
                      (RefMuLocalWindowed.load(os.path.join(port_dir, name)),
                       ml)):
        np.testing.assert_array_equal(got.edges, want.edges)
        for a, b in zip(got.cells, want.cells):
            _assert_same_arrays(a, b)

    cand = [(4, 12), (2, 14)]
    for workdir in (port_dir, ref_dir):
        path = os.path.join(workdir, StorageNames.MULOCAL_SNAPSHOTS)
        got = HyperReducedPiston.auto_cell_wn(None, cand, 1e-5, path=path)
        want = RefHROM.auto_cell_wn(None, cand, 1e-5, path=path)
        assert got[0] == want[0]
        np.testing.assert_allclose(got[1], want[1], rtol=1e-10)

    # The reference's cache in a copy of the port's working directory.
    work = tmp_path / "from_ref_cache"
    shutil.copytree(port_dir, work)
    shutil.copy(os.path.join(ref_dir, StorageNames.MULOCAL_SNAPSHOTS),
                work / StorageNames.MULOCAL_SNAPSHOTS)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(work)
        _unreachable_fom(mp, hrom)
        rebuilt = hrom.build_mulocal_serving(rnd=np.random.RandomState(1),
                                             dump=False, snapshot_cache=True,
                                             **FLEET)
    hrom.rom.mulocal = ml
    _assert_same_fleet_layout(rebuilt, ml)


def _unreachable_fom(mp, hrom):
    def boom(*a, **k):
        raise AssertionError("cache miss: the FOM was solved")

    mp.setattr(hrom.fom, "solve", boom)
    mp.setattr(port_sweep, "solve_fom_batch", boom)


def test_mulocal_snapshot_cache_rebuild(port):
    """A rebuild at another (W, N) reuses the persisted trajectories
    (``fom.solve`` and ``solve_fom_batch`` unreachable); the unchanged
    cell's bases are identical (tests/test_windowed.py:422-460)."""
    hrom, ml, workdir = port
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(workdir)
        _unreachable_fom(mp, hrom)
        rebuilt = hrom.build_mulocal_serving(
            rnd=np.random.RandomState(1), cell_wn=[(4, 12), (2, 14)],
            dump=False, snapshot_cache=True, **FLEET)
    hrom.rom.mulocal = ml
    assert rebuilt.cell_wn == [(4, 12), (2, 14)]
    np.testing.assert_array_equal(rebuilt.cells[0].Vs, ml.cells[0].Vs)
    assert hrom.fleet_seconds["training_sweep"] == 0.0


def test_mulocal_snapshot_cache_precision_guard(ref, port):
    """A cache tagged ``"device-f32"`` or untagged never serves a float64
    build: both packages re-solve, and the port re-tags the cache f64
    (tests/test_windowed.py:551-607)."""
    ref_hrom, _rml, ref_dir = ref
    hrom, ml, workdir = port
    path = os.path.join(workdir, StorageNames.MULOCAL_SNAPSHOTS)
    with np.load(path) as d:
        assert str(d["build"]) == "f64"
        payload = {k: d[k] for k in d.files}
    calls = {"n": 0}
    real = hrom.fom.solve

    def counting_solve(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(workdir)
            mp.setattr(hrom.fom, "solve", counting_solve)
            for taint in ("device-f32", None):
                tainted = dict(payload)
                if taint is None:
                    tainted.pop("build")
                else:
                    tainted["build"] = np.asarray(taint)
                np.savez(path, **tainted)
                calls["n"] = 0
                hrom.build_mulocal_serving(rnd=np.random.RandomState(1),
                                           dump=False, snapshot_cache=True,
                                           **FLEET)
                assert calls["n"] > 0, taint
                with np.load(path) as d:
                    assert str(d["build"]) == "f64"
        # The reference refuses the port's device-f32-tagged cache too.
        tainted = dict(payload, build=np.asarray("device-f32"))
        ref_fom = ref_hrom.fom
        ref_real = ref_fom.solve
        ref_calls = {"n": 0}

        def ref_counting(*a, **k):
            ref_calls["n"] += 1
            return ref_real(*a, **k)

        with pytest.MonkeyPatch.context() as mp:
            work = os.path.join(workdir, "ref_guard")
            shutil.copytree(ref_dir, work)
            mp.chdir(work)
            np.savez(StorageNames.MULOCAL_SNAPSHOTS, **tainted)
            mp.setattr(jnp.linalg, "svd", _numpy_svd)
            mp.setattr(ref_fom, "solve", ref_counting)
            ref_ml = ref_hrom.rom.mulocal
            ref_hrom.build_mulocal_serving(rnd=np.random.RandomState(1),
                                           dump=False, snapshot_cache=True,
                                           **FLEET)
            ref_hrom.rom.mulocal = ref_ml
        assert ref_calls["n"] > 0
    finally:
        np.savez(path, **payload)
        hrom.rom.mulocal = ml


def test_mulocal_mixed_cell_wn(ref, port, tmp_path):
    """A mixed fleet (cell_wn (4, 12), (2, 16), srom_extra=4,
    RandomState(5); tests/test_windowed.py:463-548) in both packages: the
    same layout and spans, its nested S-ROM cells, routed ≡ direct bit
    for bit, within 1e-3 of the FOM at the held-out μ and 1e-9·scale of
    the reference's route, the estimator finite, the npz both ways with
    the per-cell shapes."""
    ref_hrom, _rml, ref_dir = ref
    hrom, ml, workdir = port
    kw = dict(FLEET, rnd=np.random.RandomState(5),
              cell_wn=[(4, 12), (2, 16)], srom_extra=4, dump=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(workdir)
        mixed = hrom.build_mulocal_serving(**kw)
    hrom.rom.mulocal = ml
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp.linalg, "svd", _numpy_svd)
        mp.chdir(ref_dir)
        kw["rnd"] = np.random.RandomState(5)
        prev = ref_hrom.rom.mulocal
        ref_mixed = ref_hrom.build_mulocal_serving(**kw)
        ref_hrom.rom.mulocal = prev
    assert mixed.cell_wn == [(4, 12), (2, 16)] and not mixed.is_uniform
    assert [(w.n_windows, w.N) for w in mixed.cells_srom] \
        == [(4, 16), (2, 20)]
    _assert_same_fleet_layout(mixed, ref_mixed)
    for a, b in zip(mixed.cells_srom, ref_mixed.cells_srom):
        assert _projector_gap(a.Vs, b.Vs) <= 1e-8

    mus = [MU_LO, MU_HI, MU_VAL]
    routed = _port_route(hrom, mixed, mus)
    _assert_routes_close(routed, _ref_route(ref_hrom, ref_mixed, mus))
    rom = hrom.rom
    cells = [int(mixed.cell_of(RCN.compute_piston_mach_number(m)))
             for m in mus]
    assert cells[:2] == [0, 1]
    prev = rom.windows
    try:
        with compute_dtype_scope(torch.float64):
            for i, (m, c) in enumerate(zip(mus, cells)):
                rom._set_serving_windows(mixed.cells[c])
                outs = rom.solve_batch([dict(m)] * 3, step=Stage.VALIDATION,
                                       mode="full", engine="windowed")
                np.testing.assert_array_equal(routed["uc"][i],
                                              outs["uc"][0])
    finally:
        rom._set_serving_windows(prev)
    fom = hrom.fom
    with compute_dtype_scope(torch.float64):
        fom.setup()
        fom.update_parametrization(MU_VAL)
        fom.solve()
    uh_fom = np.asarray(fom.solutions.fom)
    u = np.asarray(routed["uc"][2]).T
    assert np.linalg.norm(u - uh_fom) / np.linalg.norm(uh_fom) < 1e-3

    rom.mulocal = mixed
    try:
        with compute_dtype_scope(torch.float64):
            est = hrom.estimate_batch_mulocal([dict(MU_LO), dict(MU_HI)],
                                              step=Stage.VALIDATION)
    finally:
        rom.mulocal = ml
    e = np.asarray(est[Errors.ESTIMATOR])
    assert e.shape == (2, 96) and np.isfinite(e).all() and (e >= 0).all()

    path = str(tmp_path / "mixed_mulocal.npz")
    mixed.dump(path)
    for loaded in (MuLocalWindowed.load(path), RefMuLocalWindowed.load(path)):
        assert [tuple(x) for x in loaded.cell_wn] == mixed.cell_wn
        for a, b in zip(loaded.cells, mixed.cells):
            _assert_same_arrays(a, b)


def test_mulocal_device_sweep_matches_serial(port):
    """``device_sweep=True`` (one ``solve_fom_batch`` of the fleet; float64
    on the CPU) builds the serial path's cells
    (tests/test_windowed.py:682-707)."""
    hrom, ml, workdir = port
    kw = dict(FLEET, dump=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(workdir)
        serial = hrom.build_mulocal_serving(rnd=np.random.RandomState(5),
                                            **kw)
        batched = hrom.build_mulocal_serving(rnd=np.random.RandomState(5),
                                             device_sweep=True, **kw)
    hrom.rom.mulocal = ml
    for a, b in zip(serial.cells, batched.cells):
        scale = np.abs(a.Vs).max()
        np.testing.assert_allclose(b.Vs, a.Vs, atol=1e-8 * scale)
        np.testing.assert_allclose(b.trilinear, a.trilinear,
                                   atol=1e-6 * np.abs(a.trilinear).max())


def test_paired_lu_matches_reference_kernel_on_built_cell(port, monkeypatch):
    """On a built cell (the fleet rebuilt from its trajectory cache at
    W=4, N=24: blocked LU, so the paired schedule runs followers), the
    served K1 on the reference's default schedule, opted into with
    ROMTIME_PAIRED_LU=5 (paired LU G=5, ``sub1`` followers over the
    reference's kernel chunk, ``paired_lu_period``) against the
    reference kernel ``online_sweep_windowed_fused`` in interpret mode on
    the same inputs and schedule (its interpret chunk set to that period;
    interpret mode otherwise caps the chunk at 8, where these widths run
    no follower): probes and state within 5e-5·scale
    (tests/test_pallas_online.py:779). That schedule's gap to the
    per-step LU is the reference's, not the port's."""
    import romtime_tpu.ops.pallas_online as po
    import romtime_tpu_torch.rom.engines.windowed_fused as eng

    monkeypatch.setenv("ROMTIME_PAIRED_LU", "5")

    hrom, ml, workdir = port
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(workdir)
        _unreachable_fom(mp, hrom)
        built = hrom.build_mulocal_serving(
            rnd=np.random.RandomState(1), cell_wn=[(4, 24), (4, 24)],
            dump=False, snapshot_cache=True, **FLEET)
    rom = hrom.rom
    rom.mulocal = ml
    captured = {}
    real = eng.online_sweep_windowed_fused

    def capture(*args, **kw):
        captured.update(args=args, kw=kw)
        return real(*args, **kw)

    monkeypatch.setattr(eng, "online_sweep_windowed_fused", capture)
    monkeypatch.setattr(rom, "ONLINE_PRECOMPUTE_BUDGET", 0, raising=False)
    prev = rom.windows
    try:
        rom._set_serving_windows(built.cells[1])
        rom.solve_batch([dict(MU_HI), dict(MU_VAL)] * 64, mode="probes")
    finally:
        rom._set_serving_windows(prev)
    args, kw = captured["args"], captured["kw"]
    assert kw["paired_lu"] == 5 and kw["paired_mode"] == "sub1"
    roles = step_roles(kw["period"], 5)
    assert roles.count("follow") >= 4, roles
    got_p, got_s = real(*args, **kw)
    monkeypatch.setattr(po, "_chunk_capped", lambda width, cap: kw["period"])
    ref_p, ref_s = po.online_sweep_windowed_fused(
        *[jnp.asarray(a.numpy()) for a in args],
        **{k: v for k, v in kw.items() if k != "period"}, interpret=True)
    ref_p, ref_s = np.asarray(ref_p), np.asarray(ref_s)
    scale = np.abs(ref_p).max()
    np.testing.assert_allclose(got_p.numpy(), ref_p, rtol=0,
                               atol=5e-5 * scale)
    sscale = np.abs(ref_s[[0, 2]]).max()
    np.testing.assert_allclose(got_s.numpy()[[0, 2]], ref_s[[0, 2]], rtol=0,
                               atol=5e-5 * sscale)
