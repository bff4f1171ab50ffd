"""The port's μ-local fleet (``MuLocalWindowed``, the Mach-cell router
``solve_batch_mulocal``/``route_mulocal``, the fleet branch of the solve
policy, ``WindowedServing.truncate`` and the fleet payload) against the
JAX package, on a two-cell fleet made from the conftest windowed piston
pipeline (nx=150, nt=96) with no new offline build: cell 0 is the served
windows (W=4, N=12), cell 1 the nested S-ROM windows (W=4, N=16), both
sliced from the N=16 build, so the fleet is mixed (W, N).

Anchors: tests/test_windowed.py test_mulocal_routing_matches_direct_cell_solve
(:355, atol 0), test_mulocal_npz_roundtrip_and_resume (:401),
test_mulocal_mixed_cell_wn (:463), test_windowed_truncate_nested (:610),
test_auto_solve_iters_worst_case_over_cells (:779) and
test_auto_solve_iters_per_shape_group (:813). The routed results meet the
JAX package's: "full" on engine="windowed" in float64 at 1e-9·scale, and
served probes in float32 at 5e-6·scale (uN_final 5e-5), with the merged
``dil``/``dil_oor`` equal, on a variant whose cell 1 carries a guarded
dilation law."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from romtime_tpu.conventions import Stage
from romtime_tpu.rom.registration import DilationLaw as RefDilationLaw
from romtime_tpu.rom.rom import RomConstructorNonlinear as RefRCN
from romtime_tpu.rom.windowed import MuLocalWindowed as RefMuLocalWindowed
from romtime_tpu_torch import (
    MuLocalWindowed,
    RomConstructorNonlinear,
    WindowedServing,
    fleet_serving_from_arrays,
    fleet_serving_to_arrays,
)
from romtime_tpu_torch.dtypes import compute_dtype_scope as port_dtype_scope
from romtime_tpu_torch.testing.synthetic import (
    synthetic_fleet,
    synthetic_mus,
)
from test_torch_serving import LAW_PAYLOAD
from torch_parity import (
    build_piston_hrom,
    clear_serving_caches,
    npz_arrays,
    payload_from_rom,
    reference_serving,
)

#: Two μ in each Mach cell (edges 0.15, 0.2625, 0.375): mu_lo and mu_hi
#: are the reference test's; cell 1's two straddle LAW_PAYLOAD's guard
#: (a0 = 8.1 flagged, its dilation clamped to the floor 1.0; a0 = 9.6 not
#: flagged, dilated above 1).
MUS = [dict(a0=9.8, omega=15.5, delta=0.10, alpha=1e-6, gamma=1.4),
       dict(a0=8.1, omega=19.5, delta=0.148, alpha=1e-6, gamma=1.4),
       dict(a0=9.6, omega=20.0, delta=0.15, alpha=1e-6, gamma=1.4),
       dict(a0=9.0, omega=16.0, delta=0.12, alpha=1e-6, gamma=1.4)]
CELLS = [0, 1, 1, 0]


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """(reference rom, reference nested fleet, its registered flat
    variant): the fleets are not attached; each test attaches what it
    routes and restores the reference's state."""
    hrom = build_piston_hrom(tmp_path_factory.mktemp("torch_fleet"))
    rom, srom = hrom.rom, hrom.windows_srom
    edges = RefRCN.compute_piston_mach_number_space(rom.grid, 2)
    ml = RefMuLocalWindowed(edges=edges, cells=[rom.windows, srom],
                            cells_srom=[srom, srom])
    law = RefDilationLaw.from_payload(**LAW_PAYLOAD)
    ml_reg = RefMuLocalWindowed(
        edges=edges, cells=[rom.windows,
                            dataclasses.replace(srom, dilation=law)])
    return rom, ml, ml_reg


def _port(rom, ml):
    return fleet_serving_from_arrays(payload_from_rom(rom, serving=ml),
                                     device="cpu")


def _routed_ref(rom, ml, mus=MUS, **kw):
    prev = rom.mulocal
    rom.mulocal = ml
    try:
        return rom.solve_batch_mulocal([dict(m) for m in mus], **kw)
    finally:
        rom.mulocal = prev
        clear_serving_caches(rom)


def _rows(v):
    return list(v) if isinstance(v, list) else [r for r in np.asarray(v)]


def test_fleet_routes_by_mach(fleet):
    rom, ml, _ml_reg = fleet
    port = _port(rom, ml)
    np.testing.assert_array_equal(
        RomConstructorNonlinear.compute_piston_mach_number_space(
            {k: port.grid[k] for k in ("a0", "omega", "delta")}, 2),
        ml.edges)
    pml = port.mulocal
    assert pml.n_cells == 2 and port.windows is pml.cells[0]
    mach = [RomConstructorNonlinear.compute_piston_mach_number(m)
            for m in MUS]
    assert pml.cell_of(mach).tolist() == CELLS
    assert pml.cell_of(0.0) == 0 and pml.cell_of(99.0) == 1
    assert pml.cell_of(mach).tolist() == ml.cell_of(mach).tolist()


@pytest.mark.parametrize("mode,engine", [("full", "windowed"),
                                         ("probes", "windowed-pallas")])
def test_mulocal_routing_matches_direct_cell_solve(fleet, mode, engine):
    """Routed ≡ each μ's cell attached by hand on the same padded
    sub-batch, bit for bit; the windows of before are restored."""
    rom, ml, _ml_reg = fleet
    port = _port(rom, ml)
    prev = port.windows
    key = "uc" if mode == "full" else "probes"
    with port_dtype_scope(torch.float64 if mode == "full" else
                          torch.float32):
        routed = port.solve_batch_mulocal([dict(m) for m in MUS],
                                          step=Stage.VALIDATION, mode=mode,
                                          engine=engine)
        assert port.windows is prev
        for c in (0, 1):
            idx = [i for i, cc in enumerate(CELLS) if cc == c]
            sub = [dict(MUS[i]) for i in idx] * 2
            port._set_serving_windows(port.mulocal.cells[c])
            direct = port.solve_batch(sub, step=Stage.VALIDATION, mode=mode,
                                      engine=engine)
            for j, i in enumerate(idx):
                np.testing.assert_array_equal(routed[key][i],
                                              direct[key][j])
        port._set_serving_windows(prev)


def test_mulocal_matches_reference_full_f64(fleet):
    """The port's route against the JAX package's: mode="full" on
    engine="windowed" in float64 on the registered variant."""
    rom, _ml, ml_reg = fleet
    want = _routed_ref(rom, ml_reg, step=Stage.VALIDATION, mode="full",
                       engine="windowed")
    port = _port(rom, ml_reg)
    with port_dtype_scope(torch.float64):
        got = port.solve_batch_mulocal([dict(m) for m in MUS],
                                       step=Stage.VALIDATION, mode="full",
                                       engine="windowed")
    assert set(got) == set(want) == {"t", "uN", "uc", "x", "dil",
                                     "dil_oor"}
    for k in ("uc", "x", "t"):
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-9 * scale, err_msg=k)
    assert isinstance(got["uN"], list) and isinstance(want["uN"], list)
    for g, w, c in zip(got["uN"], want["uN"], CELLS):
        assert g.shape == w.shape == (96, 12 + 4 * c)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-9 * np.abs(w).max())
    np.testing.assert_array_equal(got["dil"], want["dil"])
    np.testing.assert_array_equal(got["dil_oor"], want["dil_oor"])
    assert got["dil"][[0, 1, 3]].tolist() == [1.0] * 3
    assert got["dil"][2] > 1.0
    assert got["dil_oor"].tolist() == [0.0, 1.0, 0.0, 0.0]


def test_mulocal_matches_reference_served_probes(fleet):
    """The port's served route (f32, materialized branch) against the
    JAX package's served route on the registered variant, on 128 μ (the
    reference's materialized kernel takes whole 128-lane blocks)."""
    rom, _ml, ml_reg = fleet
    mus = MUS * 32
    with reference_serving(rom):
        want = _routed_ref(rom, ml_reg, mus, mode="probes")
    got = _port(rom, ml_reg).solve_batch_mulocal([dict(m) for m in mus])
    assert set(got) == set(want)
    scale = max(np.abs(want["probes"]).max(), 1e-3)
    np.testing.assert_allclose(got["probes"], want["probes"], rtol=0,
                               atol=5e-6 * scale)
    for g, w in zip(_rows(got["uN_final"]), _rows(want["uN_final"])):
        np.testing.assert_allclose(g, w, rtol=0, atol=5e-5)
    np.testing.assert_allclose(got["t"], want["t"], rtol=1e-6)
    np.testing.assert_array_equal(got["dil"], want["dil"])
    np.testing.assert_array_equal(got["dil_oor"], want["dil_oor"])


def _assert_windows_equal(a, b):
    np.testing.assert_array_equal(a.bounds, b.bounds)
    np.testing.assert_array_equal(a.Vs, b.Vs)
    np.testing.assert_array_equal(a.transfers, b.transfers)
    assert sorted(a.combines) == sorted(b.combines)
    for k in a.combines:
        np.testing.assert_array_equal(a.combines[k], b.combines[k])
    np.testing.assert_array_equal(a.trilinear, b.trilinear)
    assert (a.dilation is None) == (b.dilation is None)
    if a.dilation is not None:
        for k, v in a.dilation.to_payload().items():
            np.testing.assert_array_equal(v, b.dilation.to_payload()[k])


def _assert_fleets_equal(a, b):
    np.testing.assert_array_equal(a.edges, b.edges)
    assert a.cell_wn == b.cell_wn
    for x, y in zip(a.cells, b.cells):
        _assert_windows_equal(x, y)
    assert (a.cells_srom is None) == (b.cells_srom is None)
    for x, y in zip(a.cells_srom or [], b.cells_srom or []):
        _assert_windows_equal(x, y)


@pytest.mark.parametrize("form", ["nested", "flat", "legacy"])
def test_mulocal_npz_roundtrip_and_resume(fleet, tmp_path, form):
    """Each package loads the other's fleet npz bit for bit: the nested
    dump (serving_ns), the flat one, and the legacy uniform serving_n."""
    rom, ml, ml_reg = fleet
    ref_path, port_path = tmp_path / "ref.npz", tmp_path / "port.npz"
    if form == "legacy":
        srom = ml.cells_srom[0]
        arrays = {"edges": ml.edges, "serving_n": np.int64(12)}
        for c in (0, 1):
            arrays.update({f"c{c}_{k}": v
                           for k, v in npz_arrays(srom).items()})
        np.savez(ref_path, **arrays)
    else:
        (ml if form == "nested" else ml_reg).dump(ref_path)
    ref = RefMuLocalWindowed.load(ref_path)
    got = MuLocalWindowed.load(ref_path)
    _assert_fleets_equal(got, ref)
    got.dump(port_path)
    _assert_fleets_equal(RefMuLocalWindowed.load(port_path), ref)
    assert sorted(npz_arrays(got)) == sorted(npz_arrays(ref))
    if form == "legacy":
        assert got.cell_wn == [(4, 12), (4, 12)]


def test_mulocal_mixed_cell_wn(fleet, tmp_path):
    """Mixed-(W, N) fleet: per-cell shapes survive routing (the rows of a
    per-cell-N output stay a list), the fleet payload and the npz."""
    rom, ml, _ml_reg = fleet
    port = _port(rom, ml)
    pml = port.mulocal
    assert pml.cell_wn == [(4, 12), (4, 16)] and not pml.is_uniform
    assert [(w.n_windows, w.N) for w in pml.cells_srom] == [(4, 16)] * 2
    out = port.solve_batch_mulocal([dict(m) for m in MUS])
    assert [r.shape for r in out["uN_final"]] == [(12,), (16,), (16,),
                                                  (12,)]
    assert out["probes"].shape == (4, 96, 2)
    again = fleet_serving_from_arrays(fleet_serving_to_arrays(port),
                                      device="cpu")
    _assert_fleets_equal(again.mulocal, pml)
    path = tmp_path / "mixed.npz"
    pml.dump(path)
    assert MuLocalWindowed.load(path).cell_wn == pml.cell_wn


def test_windowed_truncate_nested(fleet):
    """The port's truncate equals the JAX package's bit for bit, and the
    N=12 slice of the N=16 build is the served windows."""
    rom, ml, _ml_reg = fleet
    srom = ml.cells_srom[1]
    port_srom = WindowedServing.from_arrays(npz_arrays(srom))
    for n in (12, 14, 16):
        _assert_windows_equal(port_srom.truncate(n), srom.truncate(n))
    _assert_windows_equal(port_srom.truncate(12), rom.windows)
    assert port_srom.truncate(16) is port_srom
    with pytest.raises(ValueError, match="truncate"):
        port_srom.truncate(17)


def test_cell_tables_built_once_per_cell(fleet, monkeypatch):
    """Routing swaps cells without dropping their device tables: one
    build per cell over repeated calls, the same results warm as cold; a
    replaced dilation law rebuilds its cell's tables."""
    import romtime_tpu_torch.rom.rom as rom_mod

    rom, ml, _ml_reg = fleet
    port = _port(rom, ml)
    built = []
    real = rom_mod.windowed_tables
    monkeypatch.setattr(rom_mod, "windowed_tables",
                        lambda win, *a: built.append(win) or real(win, *a))
    cold = port.solve_batch_mulocal([dict(m) for m in MUS])
    warm = port.solve_batch_mulocal([dict(m) for m in MUS])
    assert len(built) == 2 and built[0] is not built[1]
    for k in cold:
        for g, w in zip(_rows(warm[k]), _rows(cold[k])):
            np.testing.assert_array_equal(g, w)
    cell = port.mulocal.cells[1]
    from romtime_tpu_torch.rom.registration import DilationLaw

    cell.dilation = DilationLaw.from_payload(**LAW_PAYLOAD)
    out = port.solve_batch_mulocal([dict(m) for m in MUS])
    assert len(built) == 3 and built[2] is cell
    assert "dil" in out and out["dil"][2] > 1.0


def test_no_fleet_raises(fleet):
    rom, ml, _ml_reg = fleet
    port = _port(rom, ml)
    port.mulocal = None
    with pytest.raises(ValueError, match="no μ-local serving"):
        port.solve_batch_mulocal([dict(m) for m in MUS])


def test_auto_solve_iters_worst_case_over_cells(fleet, monkeypatch):
    """tests/test_windowed.py:779 on the port: on a uniform fleet the
    auto count is the worst case over the active cell's (W, N) group,
    the LU if any cell of it needs the LU."""
    rom, ml, _ml_reg = fleet
    port = _port(rom, ml)
    monkeypatch.delenv("ROMTIME_SOLVE_ITERS", raising=False)
    a = port.mulocal.cells[0]
    b = port.mulocal.cells_srom[1].truncate(12)
    port.mulocal = MuLocalWindowed(edges=port.mulocal.edges, cells=[a, b])
    fake = {id(a): 4, id(b): 9}
    monkeypatch.setattr(RomConstructorNonlinear, "_auto_iters_for",
                        lambda self, w: fake[id(w)])
    port._set_serving_windows(a)
    assert port._windowed_solve_iters() == 9   # not the active cell's 4
    port._auto_iters_cache_ml = None
    fake[id(b)] = None                         # one cell needs the LU
    assert port._windowed_solve_iters() is None
    # Windows outside the fleet decide alone.
    outside = dataclasses.replace(a)
    fake[id(outside)] = 3
    port._set_serving_windows(outside)
    assert port._windowed_solve_iters() == 3


def test_auto_solve_iters_per_shape_group(fleet, monkeypatch):
    """tests/test_windowed.py:813 on the port: each (W, N) group decides
    its own count, cached per shape on the same fleet."""
    rom, ml, _ml_reg = fleet
    port = _port(rom, ml)
    monkeypatch.delenv("ROMTIME_SOLVE_ITERS", raising=False)
    a1 = SimpleNamespace(n_windows=4, N=12)
    a2 = SimpleNamespace(n_windows=4, N=12)
    b1 = SimpleNamespace(n_windows=2, N=16)
    port.mulocal = SimpleNamespace(cells=[a1, a2, b1])
    fake = {id(a1): 3, id(a2): 5, id(b1): None}
    calls = []

    def auto_for(self, w):
        calls.append(id(w))
        return fake[id(w)]

    monkeypatch.setattr(RomConstructorNonlinear, "_auto_iters_for",
                        auto_for)
    port._set_serving_windows(a1)
    assert port._windowed_solve_iters() == 5
    port._set_serving_windows(b1)
    assert port._windowed_solve_iters() is None
    port._set_serving_windows(a2)
    assert port._windowed_solve_iters() == 5
    assert sorted(calls) == sorted([id(a1), id(a2), id(b1)])


def test_synthetic_fleet_routes_every_cell():
    """The seeded six-cell fleet at a small size (nx=150, nt=96): the
    equal-width Mach edges over the μ box, one μ routed to each cell, the
    registered cell 5's rows dilated and the rest filled with 1.0, each
    cell's rows equal to its own direct sweep."""
    cell_wn = ((4, 12),) * 4 + ((8, 16),) * 2
    rom = synthetic_fleet(cell_wn=cell_wn, nx=150, nt=96, device="cpu")
    ml = rom.mulocal
    np.testing.assert_allclose(ml.edges, np.linspace(0.15, 0.375, 7),
                               rtol=1e-15)
    assert ml.cell_wn == list(cell_wn)
    assert [w.dilation is not None for w in ml.cells] == [False] * 5 + [True]
    draw = synthetic_mus(512, seed=3)
    cells = ml.cell_of([rom.compute_piston_mach_number(m) for m in draw])
    mus = [draw[int(np.nonzero(cells == c)[0][0])] for c in range(6)]
    out = rom.solve_batch_mulocal(mus)
    assert out["probes"].shape == (6, 96, 2)
    assert np.isfinite(out["probes"]).all()
    assert [r.shape for r in out["uN_final"]] == [(N,) for _W, N in cell_wn]
    assert out["dil"][:5].tolist() == [1.0] * 5 and out["dil"][5] != 1.0
    assert out["dil_oor"][:5].tolist() == [0.0] * 5
    assert out["t"].shape == (6, 96)
    rom._set_serving_windows(ml.cells[5])
    direct = rom.solve_batch([dict(mus[5])] * 6, mode="probes")
    np.testing.assert_array_equal(out["probes"][5], direct["probes"][0])
