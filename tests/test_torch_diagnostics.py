"""The port's diagnostic scripts (romtime_tpu_torch/scripts/permu_diag.py,
multimu_diag.py, corner_attrib.py, window_study.py, kernel_ledger.py)
against the JAX originals' formulas on the CPU (scripts/permu_diag.py:
115-200, scripts/multimu_diag.py:262-289, scripts/corner_attrib.py:
46-73, scripts/window_study.py:186-207, scripts/kernel_ledger.py:24-125).

The warm directory is the conftest piston pipeline (tests/conftest.py:
50-104, built once per run by ``torch_parity.build_piston_hrom``) with
its μ space, bases and offline snapshots dumped and a two-cell fleet
made from its windows, as tests/test_torch_mulocal.py:63-75 makes one
(cell 0 the N=12 windows, cell 1 the nested N=16 S-ROM windows), dumped
beside them. The port warm-resumes that directory
(``permu_diag.build_hrom``); the JAX package's rows come from its own
``solve_batch_mulocal(engine="windowed", mode="full")`` and reductors on
the same μ, against the same FOM references (the port's npz cache).
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from romtime_tpu.conventions import Stage as RefStage
from romtime_tpu.conventions import StorageNames as RefStorageNames
from romtime_tpu.rom.rom import RomConstructorNonlinear as RefRCN
from romtime_tpu.rom.windowed import MuLocalWindowed as RefMuLocalWindowed
from romtime_tpu.rom.windowed import build_windowed_basis as ref_windowed_basis
from romtime_tpu_torch.conventions import Stage
from romtime_tpu_torch.scripts import (
    corner_attrib,
    kernel_ledger,
    multimu_diag,
    permu_diag,
    window_study,
)
from test_torch_mulocal import MUS
from test_torch_offline_build import port_setup
from torch_parity import _numpy_svd, build_piston_hrom

jax.config.update("jax_enable_x64", True)

#: Two μ of cell 0 (the center among them) and one of cell 1.
DIAG_MUS = [dict(MUS[0]), dict(MUS[2]), dict(multimu_diag.CENTER_MU)]
DIAG_CELLS = [0, 1, 0]


@pytest.fixture(scope="module")
def warm(tmp_path_factory):
    """(the reference pipeline with the fleet attached, the port resumed
    from the directory, the directory)."""
    workdir = tmp_path_factory.mktemp("diag_warm")
    ref = build_piston_hrom(workdir)
    rom, srom = ref.rom, ref.windows_srom
    ml = RefMuLocalWindowed(
        edges=RefRCN.compute_piston_mach_number_space(rom.grid, 2),
        cells=[rom.windows, srom], cells_srom=[srom, srom])
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(workdir)
        mp.setattr(jnp.linalg, "svd", _numpy_svd)
        ref.dump_mu_space()
        ref.dump_reduced_basis()
        ref.dump_offline_snapshots()
        ml.dump(RefStorageNames.WINDOWS_MULOCAL)
    rom.mulocal = ml
    port = permu_diag.build_hrom(str(workdir), profile=port_setup(),
                                 device="cpu")
    return ref, port, workdir


def _ref_full(ref, mus):
    out = ref.rom.solve_batch_mulocal([dict(m) for m in mus],
                                      step=RefStage.VALIDATION, mode="full",
                                      engine="windowed")
    return np.asarray(out["uc"])


def _ref_split(u, ref_u, win):
    """scripts/multimu_diag.py:262-289's decomposition, numpy."""
    err = u - ref_u
    nrm = np.linalg.norm(ref_u)
    floor2 = 0.0
    for w in range(win.n_windows):
        a, b = int(win.bounds[w]), int(win.bounds[w + 1])
        V = np.asarray(win.Vs[w])
        seg = err[:, a:b]
        floor2 += np.linalg.norm(seg - V @ (V.T @ seg)) ** 2
    return (np.linalg.norm(err) / nrm, np.sqrt(floor2) / nrm,
            np.sqrt(max(np.linalg.norm(err) ** 2 - floor2, 0.0)) / nrm)


def test_resume_attaches_the_fleet(warm):
    """The warm resume carries the dumped fleet: two cells, the JAX
    fleet's edges, the windows' bases bit for bit."""
    ref, port, _workdir = warm
    pml, rml = port.rom.mulocal, ref.rom.mulocal
    assert pml is not None and pml.n_cells == 2
    np.testing.assert_array_equal(pml.edges, rml.edges)
    for c in range(2):
        np.testing.assert_array_equal(np.asarray(pml.cells[c].Vs),
                                      np.asarray(rml.cells[c].Vs))
    assert np.asarray(pml.cell_of([port.rom.compute_piston_mach_number(m)
                                   for m in DIAG_MUS])).tolist() == DIAG_CELLS


def test_permu_and_multimu_rows_match_jax(warm):
    """permu_diag's per-μ rows (Mach cell, dilation, matched-grid rel-L2,
    estimator/true ratio) and multimu_diag's rel / floor / in-span split
    on the resumed fleet against the same formulas on the JAX package's
    routed ``solve_batch_mulocal(engine="windowed", mode="full")`` of the
    same μ (float64), each within 1e-9 of the rows' scale; rel² = floor²
    + inspace² to 1e-12; the two scripts' rel-L2 rows agree to 1e-12;
    the FOM cache is read back, not solved again."""
    ref, port, workdir = warm
    cache = str(workdir / permu_diag.FOM_CACHE)
    rows = permu_diag.per_mu_rows(port, DIAG_MUS, cache)
    refs = np.load(cache)["uh"]
    split = multimu_diag.diagnose(port, DIAG_MUS, port.rom.mulocal, cache)
    uc_ref = _ref_full(ref, DIAG_MUS)
    ml = ref.rom.mulocal
    want = [_ref_split(uc_ref[i].T, refs[i], ml.cells[c])
            for i, c in enumerate(DIAG_CELLS)]
    scale = max(max(w) for w in want)
    for r, s, w, c in zip(rows, split, want, DIAG_CELLS):
        assert (r["cell"], s["cell"], r["dil"]) == (c, c, 1.0)
        assert abs(r["rel"] - w[0]) <= 1e-9 * scale
        for got, expect in zip((s["rel"], s["floor"], s["inspace"]), w):
            assert abs(got - expect) <= 1e-9 * scale
        assert abs(s["rel"] ** 2 - s["floor"] ** 2 - s["inspace"] ** 2) \
            <= 1e-12 * s["rel"] ** 2
        assert abs(s["rel"] - r["rel"]) <= 1e-12 * r["rel"]
        assert np.isfinite(r["ratio"]) and r["ratio"] >= 0
    # The cell-0 rows' S-ROM is the nested N=16 windows: a resolved
    # estimator.
    assert rows[0]["ratio"] > 0


def test_corner_attribution_matches_jax_reductors(warm):
    """corner_attrib's per-reductor interpolation errors at the corner μ
    over every (nt // 8)-th step of the dilated grid against the JAX
    package's reductors' ``assemble_snapshot`` and ``_interpolate`` at the
    same μ and times, within 1e-10."""
    ref, port, _workdir = warm
    got = corner_attrib.attribute(port, n_times=8)
    ts = corner_attrib.attribution_times(port.fom, n_times=8)
    assert len(ts) == 8 and set(got) == set(corner_attrib.REDUCTORS)
    mu = corner_attrib.CORNER_MU
    for name, errs in got.items():
        red = getattr(ref, name)
        want = []
        for t in ts:
            exact = np.asarray(red.assemble_snapshot(mu, float(t)))
            approx = np.asarray(red._interpolate(mu, float(t),
                                                 which=red.FOM))
            want.append(np.linalg.norm(exact - approx)
                        / max(np.linalg.norm(exact), 1e-300))
        np.testing.assert_allclose(errs, want, rtol=0, atol=1e-10,
                                   err_msg=name)


def test_window_study_floor_matches_jax(warm):
    """window_study ``--floor-only`` at W:N = 4:12 and 4:16: the
    projection floor of the held-out μ's homogeneous FOM trajectory on the
    port's ``build_windowed_basis`` of the retained offline snapshots
    against the JAX package's on its own, within 1e-10; a point with too
    few snapshots is skipped, as the JAX script skips it; then the served
    point at 4:12 with ``--f32`` (float64 served rel-L2 near the floor's
    order, a finite float32 drift) with the fleet's active windows
    restored after."""
    ref, port, _workdir = warm
    uh_fom, uh_hom = window_study.validation_fom(port)
    nrm = np.linalg.norm(uh_fom)
    args = argparse.Namespace(points=["4:12", "4:16", "40:40"],
                              floor_only=True, f32=False)
    got = window_study.study(port, args, uh_fom, uh_hom)
    assert got["40:40"].startswith("skipped")
    for spec in ("4:12", "4:16"):
        W, N = (int(x) for x in spec.split(":"))
        bounds, Vs, _T = ref_windowed_basis(ref.srom.offline_snapshots,
                                            n_windows=W, num_basis=N)
        want = window_study.window_floor(np.asarray(bounds), np.asarray(Vs),
                                         uh_hom, nrm)
        assert abs(got[spec]["floor"] - want) <= 1e-10
    active = port.rom.windows
    try:
        served = window_study.served_point(port, 4, 12, uh_fom, uh_hom,
                                           f32=True)
    finally:
        port.rom._set_serving_windows(active)
    assert served["floor"] == pytest.approx(got["4:12"]["floor"],
                                            rel=1e-12)
    assert served["rel"] < 1e-2 and np.isfinite(served["drift"])


def test_kernel_ledger_inputs_on_the_warm_fleet(warm):
    """kernel_ledger's K1 inputs on cell 0's real tables (B=8): the twin
    over them serves the probes of the routed fleet's direct solve within
    5e-6·scale (tests/test_windowed.py:91-94), every ledger variant on
    the first windows against its twin (the wrapper is the twin on CPU
    tensors: the variants' options and finiteness), and the ledger itself
    refuses the CPU."""
    from romtime_tpu_torch.ops.windowed_fused import windowed_fused_reference

    _ref, port, _workdir = warm
    rom = port.rom
    args, kw = kernel_ledger.ledger_inputs(rom, B=8)
    assert rom.windows is rom.mulocal.cells[0]
    assert args[0].shape[2] == 8 and kw["n_real"] == 12
    probes = windowed_fused_reference(*args, **kw)[0][:, :2, :]
    mus = kernel_ledger.ledger_mus(rom, 8)
    direct = rom.solve_batch(mus, step=Stage.ONLINE, mode="probes",
                             engine="windowed-pallas")["probes"]
    got = probes.permute(2, 0, 1).numpy()
    scale = np.abs(direct).max()
    np.testing.assert_allclose(got, direct, rtol=0, atol=5e-6 * scale)
    gaps = kernel_ledger.twin_gaps(args, kw)
    assert len(gaps) == len(kernel_ledger.ledger_variants()) == 11
    # Richardson without the θ products is singular on these tables.
    assert [n for n, g in gaps.items() if np.isnan(g)] == [
        "richardson no_dots"]
    assert all(g == 0.0 for g in gaps.values() if not np.isnan(g))
    with pytest.raises(ValueError, match="CUDA"):
        kernel_ledger.ledger(args, kw)
    with pytest.raises(ValueError, match="CUDA"):
        kernel_ledger.main(["--device", "cpu"])
