"""The port's S-ROM estimator (``HyperReducedPiston.estimate_batch`` and
``estimate_batch_mulocal``, romtime_tpu_torch/rom/hrom.py), its payload
(``convert.estimator_from_arrays``/``estimator_to_arrays``) and the
numeric helpers (romtime_tpu_torch/utils/numeric.py) against the JAX
package, on the conftest piston pipeline (nx=150, nt=96) built by
tests/torch_parity.build_piston_hrom, in float64 as the reference
certifies:

- global: the ROM and the S-ROM each truncated from the N=37 S-ROM to
  N=15 and N=20 (the throughput pair; the reference's lanes scans then
  compile in seconds), anchors tests/test_windowed.py:301 and the
  three-part contract of tests/test_hrom.py:442-520;
- windowed: ``engine="windowed"`` on the W=4 windows of N=12 against the
  nested N=16 windows (tests/test_windowed.py:179);
- μ-local: a two-cell fleet whose cells are the N=16 windows sliced to
  N=12, each nesting under the N=16 windows (tests/test_windowed.py:640),
  the second cell registered, rows merged in input order.

The contract: (a) on the same trajectories the estimator equals the
reference reconstruction-norm formula ``compute_rom_difference``
(rtol 1e-10, atol 1e-17); (b) the port's trajectories meet the JAX
package's at 1e-9·scale; (c) the two estimators differ by at most the
triangle bound (b)'s gaps imply, and by 10% where the estimator is
resolved above that floor."""

import dataclasses

import numpy as np
import pytest
import torch

from romtime_tpu.conventions import Errors as RefErrors
from romtime_tpu.conventions import OperatorType, Stage
from romtime_tpu.rom.registration import DilationLaw as RefDilationLaw
from romtime_tpu.rom.rom import RomConstructorNonlinear as RefRCN
from romtime_tpu.rom.windowed import MuLocalWindowed as RefMuLocalWindowed
from romtime_tpu.rom.windowed import WindowedServing as RefWindowedServing
from romtime_tpu.utils import compute_rom_difference as ref_rom_difference
from romtime_tpu.utils import time_average as ref_time_average
from romtime_tpu_torch import estimator_from_arrays, estimator_to_arrays
from romtime_tpu_torch.conventions import Errors
from romtime_tpu_torch.dtypes import compute_dtype_scope as port_dtype_scope
from romtime_tpu_torch.utils import compute_rom_difference, time_average
from test_torch_serving import LAW_PAYLOAD
from torch_parity import (
    build_piston_hrom,
    clear_serving_caches,
    estimator_payload_from_hrom,
    npz_arrays,
    piston_mus,
)

REDUCTORS = ((OperatorType.MASS, "mdeim_Mh"),
             (OperatorType.STIFFNESS, "mdeim_Ah"),
             (OperatorType.RHS, "deim_rhs"),
             (OperatorType.CONVECTION, "mdeim_Ch"),
             (OperatorType.NONLINEAR_LIFTING, "mdeim_Nh_hat"),
             (OperatorType.TRILINEAR, "mdeim_Nh"))
#: Two μ in each Mach cell of the two-cell fleet (tests/test_torch_mulocal).
MUS = [dict(a0=9.8, omega=15.5, delta=0.10, alpha=1e-6, gamma=1.4),
       dict(a0=8.1, omega=19.5, delta=0.148, alpha=1e-6, gamma=1.4),
       dict(a0=9.6, omega=20.0, delta=0.15, alpha=1e-6, gamma=1.4),
       dict(a0=9.0, omega=16.0, delta=0.12, alpha=1e-6, gamma=1.4)]


def _nested(srom_full, n):
    """The reference's S-ROM truncated to ``n`` modes, its reductors
    attached and projected."""
    rom = srom_full.truncate(n=srom_full.N - n)
    for which, attr in REDUCTORS:
        rom.add_hyper_reductor(getattr(srom_full, attr), which)
    rom.project_reductors()
    return rom


@pytest.fixture(scope="module")
def hrom(tmp_path_factory):
    return build_piston_hrom(tmp_path_factory.mktemp("torch_estimator"))


@pytest.fixture(scope="module")
def global_pair(hrom):
    """(the N=20 S-ROM basis, the estimator payload, the reference's
    estimate on MUS) of the reference HyperReducedPiston with the N=15
    ROM and the N=20 S-ROM swapped in (its own restored at once)."""
    saved = hrom.rom, hrom.srom
    hrom.srom = _nested(saved[1], 20)
    hrom.rom = _nested(saved[1], 15)
    try:
        ref = hrom.estimate_batch([dict(m) for m in MUS], step=Stage.ONLINE)
        return (np.asarray(hrom.srom.basis), estimator_payload_from_hrom(hrom),
                ref)
    finally:
        hrom.rom, hrom.srom = saved


def _contract(est, ref, V_srom, limit=1e-9):
    """The three-part contract of tests/test_hrom.py:442-520 between the
    port's estimate ``est`` and the reference's ``ref`` (numpy, batch
    first; "rom"/"srom" hold each sweep's uN)."""
    e, e_ref = est[Errors.ESTIMATOR], np.asarray(ref[RefErrors.ESTIMATOR])
    assert e.shape == e_ref.shape
    assert np.isfinite(e).all() and (e >= 0).all()
    assert est[Errors.AVERAGE_ESTIMATOR].shape == (e.shape[0],)
    assert np.all(est[Errors.AVERAGE_ESTIMATOR] >= 0)
    uN, uNs = est["rom"], est["srom"]
    uN_ref, uNs_ref = np.asarray(ref["rom"]["uN"]), np.asarray(
        ref["srom"]["uN"])
    Nh = V_srom.shape[0]
    for b in range(e.shape[0]):
        # (a) the formula on the port's own trajectories.
        same = np.array([compute_rom_difference(uN[b, i], uNs[b, i], V_srom)
                         for i in range(uN.shape[1])])
        np.testing.assert_allclose(e[b], same, rtol=1e-10, atol=1e-17)
        # (b) the trajectories at the trajectory scale.
        d_rom = np.linalg.norm(uN[b] - uN_ref[b], axis=1)
        d_srom = np.linalg.norm(uNs[b] - uNs_ref[b], axis=1)
        scale = max(np.linalg.norm(uN_ref[b], axis=1).max(),
                    np.linalg.norm(uNs_ref[b], axis=1).max())
        assert d_rom.max() <= limit * scale, (d_rom.max(), scale)
        assert d_srom.max() <= limit * scale, (d_srom.max(), scale)
        # (c) the estimators within the triangle bound of (b)'s gaps.
        noise = (d_rom + d_srom) / np.sqrt(Nh)
        gap = np.abs(e[b] - e_ref[b])
        assert np.all(gap <= noise + 1e-12 * e_ref[b] + 1e-16), (
            (gap - noise).max())
        resolved = e_ref[b] > 20.0 * noise
        if resolved.any():
            np.testing.assert_allclose(e[b][resolved], e_ref[b][resolved],
                                       rtol=0.1)


def _host(est):
    """The port's estimate with each sweep's uN moved batch-first to the
    host, as the reference returns it."""
    out = dict(est)
    for key in ("rom", "srom"):
        out[key] = est[key]["uN"].movedim(-1, 0).cpu().numpy()
    return out


def test_estimate_batch_global_matches_reference(global_pair):
    V_srom, payload, ref = global_pair
    est = estimator_from_arrays(payload, device="cpu")
    assert est.rom.N == 15 and est.srom.N == 20
    with port_dtype_scope(torch.float64):
        assert est.rom._resolve_engine("reduced", len(MUS)) == "lanes"
        got = est.estimate_batch([dict(m) for m in MUS])
    assert isinstance(got["rom"]["uN"], torch.Tensor)
    assert got["rom"]["uN"].shape == (96, 15, len(MUS))
    _contract(_host(got), ref, V_srom)
    series = est.errors[f"{Stage.ONLINE}-estimator"]
    assert sorted(series) == list(range(len(MUS)))
    np.testing.assert_array_equal(series[1], got[Errors.ESTIMATOR][1])


def test_estimate_batch_windowed_matches_reference(hrom):
    """engine="windowed": the windows of N=12 against the nested N=16
    windows (tests/test_windowed.py:179), both swapped in and restored."""
    mus = piston_mus(3, seed=9)
    clear_serving_caches(hrom.rom)
    try:
        ref = hrom.estimate_batch([dict(m) for m in mus], step=Stage.ONLINE,
                                  engine="windowed")
    finally:
        clear_serving_caches(hrom.rom)
    est = estimator_from_arrays(
        estimator_payload_from_hrom(hrom, engine="windowed"), device="cpu")
    serving = est.rom.windows
    assert est.srom is None and est.windows_srom.N == serving.N + 4
    with port_dtype_scope(torch.float64):
        got = est.estimate_batch([dict(m) for m in mus], engine="windowed")
    assert est.rom.windows is serving
    # The per-window bases nest: (a) holds on the first window's basis.
    _contract(_host(got), ref, np.asarray(hrom.windows_srom.Vs[0]))


def test_estimate_batch_mulocal_matches_reference(hrom, monkeypatch):
    """estimate_batch_mulocal on a two-cell fleet whose cells nest the
    N=12 serving cells under the N=16 windows (test_windowed.py:640),
    cell 1 registered (LAW_PAYLOAD's dilation law on both its serving and
    its S-ROM windows): routed, estimated per cell and merged in input
    order. Each μ's row meets the JAX package's by the three-part
    contract, the trajectories taken from the reference's per-cell
    ``estimate_batch`` calls. Averages: cell 0's within the time average
    of (c)'s bound; on the registered cell the port averages each μ over
    its own clock, trapz(e, t_μ)/max(t_μ), where the reference's row is
    trapz(e, t_l)/max over the cell's lanes for every lane l, so the
    port's equals the reference's own-lane entry times
    max(t_cell)/max(t_μ). A permuted batch returns the permuted rows bit
    for bit, and the active windows and ``windows_srom`` are restored."""
    rom, srom_win = hrom.rom, hrom.windows_srom
    edges = RefRCN.compute_piston_mach_number_space(rom.grid, 2)
    cell = srom_win.truncate(12)
    law = RefDilationLaw.from_payload(**LAW_PAYLOAD)
    ml = RefMuLocalWindowed(
        edges=edges, cells=[cell, dataclasses.replace(cell, dilation=law)],
        cells_srom=[srom_win, dataclasses.replace(srom_win, dilation=law)])
    mach = [RefRCN.compute_piston_mach_number(m) for m in MUS]
    cells = ml.cell_of(mach)
    assert cells.tolist() == [0, 1, 1, 0]
    calls = []
    real = hrom.estimate_batch
    monkeypatch.setattr(hrom, "estimate_batch", lambda *a, **k: (
        calls.append(real(*a, **k)) or calls[-1]))
    prev = rom.mulocal, rom.windows
    rom.mulocal = ml
    try:
        ref = hrom.estimate_batch_mulocal([dict(m) for m in MUS],
                                          step=Stage.ONLINE)
    finally:
        rom.mulocal = prev[0]
        rom._set_serving_windows(prev[1])
        clear_serving_caches(rom)
    assert len(calls) == 2
    est = estimator_from_arrays(estimator_payload_from_hrom(hrom, fleet=ml),
                                device="cpu")
    pml = est.rom.mulocal
    assert [w.N for w in pml.cells_srom] == [16, 16]
    assert [w.dilation is not None for w in pml.cells] == [False, True]
    active = est.rom.windows
    with port_dtype_scope(torch.float64):
        got = est.estimate_batch_mulocal([dict(m) for m in MUS])
        perm = [2, 0, 3, 1]
        again = est.estimate_batch_mulocal([dict(MUS[i]) for i in perm])
    assert est.rom.windows is active and est.windows_srom is None
    e, avg = got[Errors.ESTIMATOR], got[Errors.AVERAGE_ESTIMATOR]
    assert e.shape == (len(MUS), 96) and avg.shape == (len(MUS),)
    assert np.all(np.isfinite(avg)) and np.all(avg > 0)
    # The reference's per-cell rows in input order (sub-batch position j).
    rows = {key: [None] * len(MUS) for key in ("rom", "srom", "t", "e")}
    own = [None] * len(MUS)
    for c, out in enumerate(calls):
        idx = np.nonzero(cells == c)[0]
        ts = np.asarray(out["rom"]["t"])
        for j, i in enumerate(idx):
            rows["rom"][i] = np.asarray(out["rom"]["uN"][j])
            rows["srom"][i] = np.asarray(out["srom"]["uN"][j])
            rows["e"][i] = np.asarray(out[RefErrors.ESTIMATOR][j])
            rows["t"][i] = ts[j] if ts.ndim == 2 else ts
            own[i] = (j, ts)
    for i in range(len(MUS)):
        np.testing.assert_array_equal(
            np.asarray(ref[RefErrors.ESTIMATOR][i]), rows["e"][i])
    ref_rows = {RefErrors.ESTIMATOR: np.stack(rows["e"]),
                "rom": {"uN": np.stack(rows["rom"])},
                "srom": {"uN": np.stack(rows["srom"])}}
    V_srom = np.asarray(srom_win.Vs[0])
    _contract(got, ref_rows, V_srom)
    departed = []
    for i in range(len(MUS)):
        noise = (np.linalg.norm(got["rom"][i] - rows["rom"][i], axis=1)
                 + np.linalg.norm(got["srom"][i] - rows["srom"][i], axis=1)
                 ) / np.sqrt(V_srom.shape[0])
        t_i = rows["t"][i]
        np.testing.assert_allclose(avg[i], time_average(t_i, e[i]),
                                   rtol=1e-12)
        ref_avg = np.asarray(ref[RefErrors.AVERAGE_ESTIMATOR][i])
        if cells[i] == 0:
            assert ref_avg.shape == ()
            want = float(ref_avg)
        else:
            j, ts = own[i]
            assert ref_avg.shape == (len(MUS),)
            factor = np.max(ts) / np.max(t_i)
            departed.append(factor)
            want = float(ref_avg[j]) * factor
        limit = time_average(t_i, noise) + 1e-12 * want + 1e-16
        assert abs(avg[i] - want) <= limit, (i, avg[i], want, limit)
    # The registered cell's clocks differ, so the departure is exercised.
    assert max(abs(f - 1.0) for f in departed) > 1e-3, departed
    np.testing.assert_array_equal(again[Errors.ESTIMATOR], e[perm])
    np.testing.assert_array_equal(again[Errors.AVERAGE_ESTIMATOR], avg[perm])
    for key in ("rom", "srom"):
        np.testing.assert_array_equal(again[key], got[key][perm])


@pytest.mark.parametrize("form", ["global", "windowed", "fleet"])
def test_estimator_payload_roundtrip(global_pair, hrom, form):
    """The estimator payload both ways: the JAX-built payload → the port
    → ``estimator_to_arrays`` gives the same keys and arrays, and the
    JAX package reads the port's S-ROM windows."""
    if form == "global":
        payload = global_pair[1]
    elif form == "windowed":
        payload = estimator_payload_from_hrom(hrom, engine="windowed")
    else:
        win = hrom.windows_srom
        ml = RefMuLocalWindowed(
            edges=RefRCN.compute_piston_mach_number_space(hrom.rom.grid, 2),
            cells=[win.truncate(12)] * 2, cells_srom=[win, win])
        payload = estimator_payload_from_hrom(hrom, fleet=ml)
    est = estimator_from_arrays(payload, device="cpu")
    back = estimator_to_arrays(est)
    assert set(back) == set(payload)
    for key in payload:
        np.testing.assert_array_equal(back[key], payload[key], err_msg=key)
    if form == "windowed":
        srom = {k[len("srom_"):]: v for k, v in back.items()
                if k.startswith("srom_")}
        ref_win = RefWindowedServing(**{
            "bounds": srom["bounds"], "Vs": srom["Vs"],
            "transfers": srom["transfers"],
            "combines": {k[len("combine_"):]: v for k, v in srom.items()
                         if k.startswith("combine_")},
            "trilinear": srom["trilinear"]})
        for k, v in npz_arrays(ref_win).items():
            np.testing.assert_array_equal(v, srom[k], err_msg=k)


def test_numeric_helpers_match_reference():
    """``time_average`` and ``compute_rom_difference`` against the JAX
    package's own (romtime_tpu/utils/numeric.py:29-60), bit for bit."""
    rng = np.random.default_rng(2)
    ts = np.linspace(0.01, 0.6, 60)
    f = rng.normal(size=60) ** 2
    assert time_average(ts, f) == ref_time_average(ts, f)
    V = np.linalg.qr(rng.normal(size=(40, 9)))[0]
    uN, uN_srom = rng.normal(size=6), rng.normal(size=9)
    assert (compute_rom_difference(uN, uN_srom, V)
            == ref_rom_difference(uN, uN_srom, V))
    # The coefficient norm of the batched estimator, on orthonormal V.
    diff = uN_srom - np.append(uN, [0.0] * 3)
    np.testing.assert_allclose(np.linalg.norm(diff) / np.sqrt(40),
                               compute_rom_difference(uN, uN_srom, V),
                               rtol=1e-12)
