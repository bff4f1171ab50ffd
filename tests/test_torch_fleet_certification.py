"""The bench entry's fleet certification (``romtime_tpu_torch/bench.py``
``fleet_certification``, ``hold_certification``: bench.py:442-705 and
:963-995, run by ``chip_smoke.py``'s phase 12 (d)) on the CPU against
the same bench.py arithmetic applied to the JAX package's outputs.

The fleet: a registered two-cell fleet built by the JAX package on the
conftest piston pipeline (nx=150, nt=96; tests/torch_parity.py's shared
build) at tests/test_registration.py:418's settings (K=2, W=4, N=12, 3 μ
a cell, RandomState(2), ``register=[1]``) with nested S-ROM cells
(``srom_extra=4``), carried to the port through its estimator payload
(``estimator_payload_from_hrom(fleet=...)``, ``device="cpu"``). Both
sides certify bench's center μ, its 15 held-out μ (8 in cell 0, 7 in the
registered cell 1, 3 of them off the law's floor d = 1) and a 128-lane timed batch (bench's 64-bin draws
tiled; 128 lanes, the reference kernels' block) served in float32 on
the active cell.

Limits, each from the arithmetic's inputs:

- the float64 rel-L2s (matched grid, standard clock) and the FOM
  dt-gaps: 1e-9 absolute. They are relative to the FOM's norm, and the
  two packages' float64 trajectories agree to 1e-9·scale
  (tests/test_windowed.py's lanes limit), which bounds their gap;
- each estimator/true ratio: 1e-9 / (that μ's rel-L2) relative, the gap
  the same bound allows the true error, plus the estimator's own
  (tests/test_torch_estimator.py's triangle bound, here as a relative
  gap of the time-RMS estimator);
- the float32 served probe error and the float32 drift: 5e-6 of their
  scale (tests/test_windowed.py:91-94's float32 serving limit)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romtime_tpu.conventions import Errors as RefErrors
from romtime_tpu.conventions import Stage as RefStage
from romtime_tpu.dtypes import compute_dtype_scope as ref_dtype_scope
from romtime_tpu.rom.registration import (
    resample_to_standard as ref_resample,
)
from romtime_tpu.utils import time_average as ref_time_average
from romtime_tpu_torch import bench as pb
from romtime_tpu_torch import estimator_from_arrays
from romtime_tpu_torch.dtypes import compute_dtype_scope
from torch_parity import (
    _numpy_svd,
    build_piston_hrom,
    clear_serving_caches,
    estimator_payload_from_hrom,
)

#: tests/test_registration.py:418-434's fleet, nested for the estimator.
FLEET = dict(n_cells=2, n_windows=4, num_basis=12, snapshots_per_cell=3,
             register=[1], srom_extra=4)
TIMED_B = 128
REL_ATOL = 1e-9
F32_REL = 5e-6
CENTER = dict(a0=9.3, omega=17.5, delta=0.12, alpha=1e-6, gamma=1.4)


def _ref_fom(fom, mu, d=1.0):
    """bench.py:444-466's FOM reference: (nh, nt) on the grid T·d."""
    t_orig = fom.domain[fom.T]
    try:
        if d != 1.0:
            fom.domain[fom.T] = float(t_orig) * float(d)
            fom._solve_jit = {}
        fom.setup()
        fom.update_parametrization(mu)
        fom.solve()
        return np.asarray(fom.solutions.fom)
    finally:
        if d != 1.0:
            fom.domain[fom.T] = t_orig
            fom._solve_jit = {}


def _bench_reference(hrom, timed_mus, timed_probes):
    """bench.py:442-705 and :963-995 on the JAX package's fleet, its own
    calls, float64 but for the served batch and the drift."""
    rom, fom, ml = hrom.rom, hrom.fom, hrom.rom.mulocal
    mu_val = dict(CENTER)
    mus_val = list(rom.build_sampling_space(
        num=16, rnd=np.random.RandomState(7)))[:16]
    for m in mus_val:
        m.pop("piston_mach", None)
    active = int(ml.cell_of(rom.compute_piston_mach_number(mu_val)))
    prev = rom.windows
    rom._set_serving_windows(ml.cells[active])
    try:
        with ref_dtype_scope(jnp.float64):
            outs_v = rom.solve_batch([dict(mu_val)], step=RefStage.VALIDATION,
                                     mode="full", engine="windowed")
            outs_m = rom.solve_batch_mulocal(
                [dict(m) for m in mus_val], step=RefStage.VALIDATION,
                mode="full", engine="windowed")
            est = hrom.estimate_batch_mulocal([dict(m) for m in mus_val],
                                              step=RefStage.VALIDATION)
            ref = rom.solve_batch([dict(m) for m in timed_mus[:16]],
                                  step=RefStage.ONLINE, mode="probes",
                                  engine="windowed")
        with ref_dtype_scope(jnp.float32):
            clear_serving_caches(rom)
            outs32 = rom.solve_batch([dict(mu_val)],
                                     step=RefStage.VALIDATION, mode="full",
                                     engine="windowed")
    finally:
        rom._set_serving_windows(prev)
        clear_serving_caches(rom)
    uh_rom = np.asarray(outs_v["uc"][0]).T
    dil_val = float(np.asarray(outs_v.get("dil", [1.0]))[0])
    uh_fom = _ref_fom(fom, mu_val, dil_val)
    dils_m = np.asarray(outs_m["dil"], np.float64)
    fom_refs = [_ref_fom(fom, m, float(d)) for m, d in zip(mus_val, dils_m)]
    rels = [float(np.linalg.norm(np.asarray(outs_m["uc"][i]).T - fom_refs[i])
                  / np.linalg.norm(fom_refs[i])) for i in range(len(mus_val))]
    std, gaps = {}, {}
    for i in range(len(mus_val)):
        if dils_m[i] == 1.0:
            continue
        d_i = float(dils_m[i])
        rom_std = ref_resample(np.asarray(outs_m["uc"][i], np.float64), d_i,
                               axis=0).T
        ref_std = ref_resample(fom_refs[i], d_i, axis=1)
        fom_std = _ref_fom(fom, mus_val[i], 1.0)
        std[i] = float(np.linalg.norm(rom_std - ref_std)
                       / np.linalg.norm(ref_std))
        gaps[i] = float(np.linalg.norm(ref_std - fom_std)
                        / np.linalg.norm(fom_std))
    e = [np.asarray(row) for row in est[RefErrors.ESTIMATOR]]
    ratios = []
    for i in range(len(mus_val)):
        uh_i = np.asarray(outs_m["uc"][i]).T
        true_rms = np.linalg.norm(uh_i - fom_refs[i]) / np.sqrt(uh_i.size)
        ratios.append(float(np.sqrt(np.mean(e[i] ** 2)))
                      / max(true_rms, 1e-300))
    # Each μ's estimator averaged over its own clock: the port's stated
    # departure on registered cells (ROADMAP Queue 3), where the
    # reference returns a (B, B) row.
    avg = [float(ref_time_average(np.asarray(outs_m["t"][i]), e[i]))
           for i in range(len(mus_val))]
    p_ref = np.asarray(ref["probes"])
    p_timed = np.asarray(timed_probes)[:16]
    return dict(
        rel_l2_vs_fom=float(np.linalg.norm(uh_rom - uh_fom)
                            / np.linalg.norm(uh_fom)),
        rels=rels, std=std, gaps=gaps, ratios=ratios, dils=dils_m,
        n_dil_flagged=int(np.sum(np.asarray(outs_m["dil_oor"]) > 0.5)),
        avg_estimator_mean=float(np.mean(avg)), active=active,
        served_engine_probe_err=float(np.abs(p_timed - p_ref).max()
                                      / max(float(np.abs(p_ref).max()),
                                            1e-12)),
        f32_serving_drift=float(np.linalg.norm(
            np.asarray(outs32["uc"][0]).T - uh_rom) / np.linalg.norm(uh_fom)),
        nh=uh_fom.shape[0], e_rms=[float(np.sqrt(np.mean(r ** 2)))
                                   for r in e])


@pytest.fixture(scope="module")
def certified(tmp_path_factory):
    """(the port's certification, its estimate, the JAX package's
    arithmetic) on the same carried-across fleet."""
    workdir = tmp_path_factory.mktemp("fleet_certification")
    hrom = build_piston_hrom(workdir)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp.linalg, "svd", _numpy_svd)
        mp.chdir(workdir)
        ml = hrom.build_mulocal_serving(rnd=np.random.RandomState(2),
                                        dump=False, snapshot_cache=False,
                                        **FLEET)
    assert [w.dilation is not None for w in ml.cells] == [False, True]
    port = estimator_from_arrays(
        estimator_payload_from_hrom(hrom, fleet=ml), device="cpu")
    prom, rom = port.rom, hrom.rom
    timed_mus = pb.bench_mus(prom, pb.TIMED_SPACE, 3, TIMED_B)
    active = int(prom.mulocal.cell_of(prom.compute_piston_mach_number(
        CENTER)))
    prom._set_serving_windows(prom.mulocal.cells[active])
    with compute_dtype_scope(torch.float32):
        served = prom.solve_batch(timed_mus, mode="probes", host=False)
    prom._set_serving_windows(prom.mulocal.cells[0])
    rom._set_serving_windows(ml.cells[active])
    try:
        with ref_dtype_scope(jnp.float32):
            clear_serving_caches(rom)
            ref_served = rom.solve_batch([dict(m) for m in timed_mus],
                                         step=RefStage.ONLINE, mode="probes")
    finally:
        rom._set_serving_windows(ml.cells[0])
        clear_serving_caches(rom)
    cert, est = pb.fleet_certification(port, timed_mus, served["probes"])
    ref = _bench_reference(hrom, timed_mus, ref_served["probes"])
    return cert, est, ref


def test_center_and_keys(certified):
    """bench.py's key names and structure; the center μ's float64
    rel-L2 on its matched grid within 1e-9 of the JAX package's."""
    cert, _est, ref = certified
    assert set(cert) >= {"rel_l2_vs_fom", "rel_l2_multi_mu",
                         "rel_l2_multi_mu_std", "windowed_estimator",
                         "served_engine_probe_err", "f32_serving_drift"}
    assert set(cert["rel_l2_multi_mu"]) == {"n", "mean", "max",
                                            "n_registered", "dil_max",
                                            "n_dil_flagged", "std"}
    assert set(cert["rel_l2_multi_mu"]["std"]) == {
        "n", "mean", "max", "fom_dt_gap_mean", "fom_dt_gap_max"}
    assert set(cert["windowed_estimator"]) == {"avg_estimator_mean",
                                               "ratio_min", "ratio_max"}
    assert cert["active_cell"] == ref["active"] == 0
    assert abs(cert["rel_l2_vs_fom"] - ref["rel_l2_vs_fom"]) <= REL_ATOL


def test_held_out_matched_grid(certified):
    """The 15 held-out μ: dilations, registered and flagged counts, each
    μ's rel-L2 on its matched grid within 1e-9, and the mean and max."""
    cert, _est, ref = certified
    multi, rows = cert["rel_l2_multi_mu"], cert["rows"]
    assert multi["n"] == len(rows) == len(ref["rels"]) == 15
    np.testing.assert_allclose([r["dil"] for r in rows], ref["dils"],
                               rtol=1e-12, atol=0)
    assert multi["n_registered"] == int(np.sum(ref["dils"] != 1.0)) > 0
    assert multi["n_dil_flagged"] == ref["n_dil_flagged"]
    assert multi["dil_max"] == pytest.approx(float(np.max(ref["dils"])),
                                             rel=1e-12)
    got = np.array([r["rel_l2"] for r in rows])
    np.testing.assert_allclose(got, ref["rels"], rtol=0, atol=REL_ATOL)
    assert abs(multi["max"] - max(ref["rels"])) <= REL_ATOL
    assert abs(multi["mean"] - np.mean(ref["rels"])) <= REL_ATOL


def test_standard_clock(certified):
    """The registered lanes on the standard clock: each rel-L2 and FOM
    dt-gap within 1e-9 of the JAX package's, and their summaries."""
    cert, _est, ref = certified
    rows, std = cert["rows"], cert["rel_l2_multi_mu"]["std"]
    assert sorted(i for i, r in enumerate(rows)
                  if r["rel_l2_std"] is not None) == sorted(ref["std"])
    assert std["n"] == len(ref["std"])
    for i, want in ref["std"].items():
        assert abs(rows[i]["rel_l2_std"] - want) <= REL_ATOL, i
        assert abs(rows[i]["fom_dt_gap"] - ref["gaps"][i]) <= REL_ATOL, i
    assert abs(std["max"] - max(ref["std"].values())) <= REL_ATOL
    assert abs(std["fom_dt_gap_max"] - max(ref["gaps"].values())) <= REL_ATOL
    assert cert["rel_l2_multi_mu_std"] == std


def test_estimator_ratios(certified):
    """Each μ's estimator/true ratio within 1e-9 / rel-L2 relative (the
    true error's bound) plus the estimator's own relative gap: its rows
    differ by at most (d_rom + d_srom)/√nh (tests/test_torch_estimator.py's
    triangle bound) with each trajectory gap within 1e-9 of their scale;
    the range, and the mean of the per-μ averages at the same bound."""
    cert, est, ref = certified
    scale = max(float(np.linalg.norm(np.asarray(est[key][i]), axis=1).max())
                for key in ("rom", "srom") for i in range(len(est["rom"])))
    noise = 2 * REL_ATOL * scale / np.sqrt(ref["nh"])
    rows = cert["rows"]
    for i, r in enumerate(rows):
        tol = REL_ATOL / r["rel_l2"] + noise / ref["e_rms"][i]
        assert abs(r["ratio"] - ref["ratios"][i]) <= tol * ref["ratios"][i], (
            i, r["ratio"], ref["ratios"][i], tol)
    w = cert["windowed_estimator"]
    assert w["ratio_min"] == min(r["ratio"] for r in rows)
    assert w["ratio_max"] == max(r["ratio"] for r in rows)
    assert abs(w["avg_estimator_mean"] - ref["avg_estimator_mean"]) <= noise


def test_probe_error_and_drift(certified):
    """The served float32 batch's first 16 probe rows against the float64
    lanes engine, and the center's float32 drift: within 5e-6 (of their
    scale) of the JAX package's."""
    cert, _est, ref = certified
    assert abs(cert["served_engine_probe_err"]
               - ref["served_engine_probe_err"]) <= F32_REL
    assert abs(cert["f32_serving_drift"] - ref["f32_serving_drift"]) <= F32_REL
    assert 0 < cert["served_engine_probe_err"] < 1e-3
    assert 0 < cert["f32_serving_drift"] < 1e-3


@pytest.mark.parametrize("name", sorted(pb.FLEET_CERT_LIMITS))
def test_limit_below_the_measured_value_raises(certified, name):
    """hold_certification passes at limits that hold every number and
    raises, naming it, when one limit is moved past the measured value."""
    cert = certified[0]
    numbers = pb.certified_numbers(cert)
    holding = {k: (0.5 * v if k == "ratio_min" else 2.0 * v)
               for k, v in numbers.items()}
    pb.hold_certification(cert, "cpu", limits=holding)
    missed = dict(holding, **{name: (2.0 * numbers[name]
                                     if name == "ratio_min"
                                     else 0.5 * numbers[name])})
    with pytest.raises(AssertionError, match=name):
        pb.hold_certification(cert, "cpu", limits=missed)


def test_carried_rom_samples_as_the_build(tmp_path):
    """A serving object carried across by its payload draws bench's
    held-out μ as the JAX package's built ROM does (the same stream, the
    fixed α and γ at their values): the payload keeps each distribution's
    box, a fixed parameter as (value, value) where scipy's support is nan,
    and the port reads it back as frozen uniforms. The port's own payload
    writes the same boxes."""
    from romtime_tpu_torch import estimator_to_arrays

    hrom = build_piston_hrom(tmp_path)
    payload = estimator_payload_from_hrom(hrom, engine="windowed")
    np.testing.assert_array_equal(payload["grid_alpha"], [1e-6, 1e-6])
    np.testing.assert_array_equal(payload["grid_gamma"], [1.4, 1.4])
    port = estimator_from_arrays(payload, device="cpu")
    for num, seed in ((16, 7), (64, 3)):
        want = list(hrom.rom.build_sampling_space(
            num=num, rnd=np.random.RandomState(seed)))
        got = list(port.rom.build_sampling_space(
            num=num, rnd=np.random.RandomState(seed)))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                assert float(g[k]) == pytest.approx(float(w[k]), rel=1e-15,
                                                    abs=0), (k, g, w)
    again = estimator_to_arrays(port)
    for k in payload:
        if k.startswith("grid_"):
            np.testing.assert_array_equal(again[k], payload[k])
    # The guard and the policy probe the box the distributions give: a
    # fixed parameter's as nan, as the built ROM's and the reference's.
    assert np.isnan(port.rom.grid["alpha"]).all()
    assert port.rom.grid["a0"] == (8.0, 10.0)
