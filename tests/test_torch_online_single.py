"""The port's single-μ online path, its vmap engine and the pipeline's
evaluation half (romtime_tpu_torch/rom/rom.py ``solve``,
``_online_scan``, ``engine="vmap"``, the reduced assembly API;
rom/hrom.py ``evaluate_validation``, ``evaluate_online``, ``_evaluate``,
the piston post-processing, ``evaluate_deim``, the dumps,
``generate_summary``; deim/deim.py ``Nh``, ``compute_thetas``) against
the JAX package's, on the conftest piston pipeline (tests/conftest.py:
50-104: nx=150, nt=96, global N=35, S-ROM N=37, windows attached), built
by the reference (its SVD through numpy, tests/torch_parity.py) and
resumed by the port from its pickles (``port_on_ref``: the same bases
bit for bit), and built by the port (tests/test_torch_offline_build.py
``port_build``). Each test names the reference test it mirrors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romtime_tpu.conventions import Stage as RefStage
from romtime_tpu.dtypes import compute_dtype_scope as ref_dtype_scope
from romtime_tpu_torch.conventions import Errors, Stage, StorageNames
from romtime_tpu_torch.dtypes import compute_dtype_scope
from romtime_tpu_torch.rom.hrom import HyperReducedPiston
from romtime_tpu_torch.utils import compute_rom_difference
from test_torch_offline_build import MUS, REDUCTORS, port_build, port_setup
from torch_parity import _numpy_svd, build_piston_hrom, piston_mus

jax.config.update("jax_enable_x64", True)


@pytest.fixture(scope="module")
def ref_hrom(tmp_path_factory):
    """The reference's pipeline, its μ space and bases dumped beside its
    reductor pickles."""
    workdir = tmp_path_factory.mktemp("ref_build")
    hrom = build_piston_hrom(workdir)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(workdir)
        mp.setattr(jnp.linalg, "svd", _numpy_svd)
        hrom.dump_mu_space()
        hrom.dump_reduced_basis()
    return hrom, workdir


@pytest.fixture(scope="module")
def port_hrom(tmp_path_factory):
    """The port's own build of the same pipeline."""
    workdir = tmp_path_factory.mktemp("port_build")
    return port_build(workdir), workdir


MU_VAL = dict(a0=9.3, omega=17.5, delta=0.12, alpha=1e-6, gamma=1.4)


@pytest.fixture(scope="module")
def port_on_ref(ref_hrom, tmp_path_factory):
    """The port's pipeline resumed in the reference's directory (its
    bases and reductors' collateral bases bit for bit) with the
    reference's validation trajectories (``dump_validation_fom`` read by
    ``load_validation_fom``)."""
    ref, ref_dir = ref_hrom
    path = tmp_path_factory.mktemp("validation") / "validation.pkl"
    ref.dump_validation_fom(str(path))
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(ref_dir)
        port = HyperReducedPiston(**port_setup())
        port.setup()
        port.setup_hyperreduction()
        port.start_from_existing_basis()
        port.project_reductors()
    port.load_validation_fom(str(path))
    return port


def _ref_solve(rom, mu):
    rom.solve(mu=dict(mu), step=RefStage.ONLINE)
    return rom.solutions


def test_solve_matches_reference_solve(ref_hrom, port_on_ref):
    """tests/test_hrom.py:409's single-μ solve in float64 on the same
    built ROM (windows attached in both): the reconstructed trajectory,
    the reduced coefficients, the domain and the times within
    1e-9·scale of the reference's ``RomConstructor.solve``; ``N`` is the
    basis's, not the windows' (reference rom.py:145-147)."""
    ref, port = ref_hrom[0], port_on_ref
    rom = port.rom
    assert rom.windows is not None and rom.windows.N != rom.basis.shape[1]
    assert rom.N == rom.basis.shape[1] == ref.rom.N
    with ref_dtype_scope(jnp.float64):
        want = _ref_solve(ref.rom, MU_VAL)
    with compute_dtype_scope(torch.float64):
        idx = rom.solve(MU_VAL, Stage.ONLINE)
    got = rom.solutions
    assert idx == len(rom.mu_space[Stage.ONLINE]) - 1
    scale = np.abs(want.fom).max()
    assert got.fom.shape == want.fom.shape == (151, 96)
    assert np.abs(got.fom - np.asarray(want.fom)).max() <= 1e-9 * scale
    assert np.abs(got.rom - np.asarray(want.rom)).max() <= 1e-9 * max(
        np.abs(want.rom).max(), 1.0)
    np.testing.assert_allclose(got.domain, want.domain, rtol=1e-12)
    np.testing.assert_allclose(got.ts, want.ts, rtol=1e-12)
    assert rom.timesteps is got.ts


def test_solve_equals_lanes_and_vmap_rows(port_hrom):
    """tests/test_rom.py:114 on the port's own built ROM: each row of
    ``solve_batch(mode="full")`` on the lanes engine and on the vmap
    engine equals ``solve`` on its μ at 1e-12 (float64); the probes and
    reduced modes of the vmap engine are its full mode's."""
    rom = port_hrom[0].rom
    mus = [dict(m) for m in MUS]
    with compute_dtype_scope(torch.float64):
        lanes = rom.solve_batch(mus, mode="full", engine="lanes")
        vmap = rom.solve_batch(mus, mode="full", engine="vmap")
        probes = rom.solve_batch(mus, mode="probes", engine="vmap")
        reduced = rom.solve_batch(mus, mode="reduced", engine="vmap")
        for i, mu in enumerate(mus):
            rom.solve(mu=mu, step=Stage.ONLINE)
            for out in (lanes, vmap):
                np.testing.assert_allclose(out["uc"][i].T, rom.solutions.fom,
                                           rtol=0, atol=1e-12)
                np.testing.assert_allclose(out["uN"][i].T, rom.solutions.rom,
                                           rtol=0, atol=1e-12)
    np.testing.assert_array_equal(reduced["uN"], vmap["uN"])
    np.testing.assert_array_equal(probes["uN_final"], vmap["uN"][:, -1])
    np.testing.assert_array_equal(probes["probes"], reduced["probes"])
    ends = np.stack([vmap["uc"][:, :, 0], vmap["uc"][:, :, -1]], axis=-1)
    np.testing.assert_allclose(probes["probes"], ends, rtol=0, atol=1e-12)


@pytest.mark.parametrize("missing", ["mdeim_Ch", "mdeim_Nh"])
def test_vmap_engine_where_the_reference_takes_it(ref_hrom, port_on_ref,
                                                  missing, monkeypatch):
    """rom.py:1262-1267: without one reductor (the convection MDEIM, or
    the trilinear N-MDEIM) both packages resolve a bare ``solve_batch``
    to "vmap", with every reductor to "lanes"; the port's call runs
    ``_online_scan`` over the batch (a routing spy), each row ``solve`` on
    its μ at 1e-12 in float64, within 1e-9·scale of the reductor-complete
    ROM (the projection stands in for the reductor)."""
    ref, port = ref_hrom[0], port_on_ref
    rom = port.rom
    assert rom._resolve_engine("reduced", 3) == "lanes"
    assert ref.rom._resolve_engine("reduced", 3) == "lanes"
    with compute_dtype_scope(torch.float64):
        full = rom.solve_batch(MUS[:2], mode="full", engine="lanes")
    monkeypatch.setattr(rom, missing, None)
    monkeypatch.setattr(ref.rom, missing, None)
    rom._reset_serving()
    assert ref.rom._resolve_engine("full", 2) == "vmap"
    assert rom._resolve_engine("full", 2) == "vmap"
    calls = []
    real = rom._online_scan

    def spy(mu, mode="full"):
        calls.append((mode, next(iter(mu.values())).shape[0]))
        return real(mu, mode)

    monkeypatch.setattr(rom, "_online_scan", spy)
    try:
        with compute_dtype_scope(torch.float64):
            out = rom.solve_batch(MUS[:2], mode="full")
            assert calls == [("full", 2)]
            for i, mu in enumerate(MUS[:2]):
                rom.solve(mu=dict(mu), step=Stage.ONLINE)
                np.testing.assert_allclose(out["uc"][i].T, rom.solutions.fom,
                                           rtol=0, atol=1e-12)
    finally:
        monkeypatch.undo()
        rom._reset_serving()
        rom.project_reductors()
    scale = np.abs(full["uc"]).max()
    assert np.abs(out["uc"] - full["uc"]).max() <= 1e-9 * scale


def test_solve_batch_keeps_the_mu_record(port_hrom):
    """tests/test_rom.py:276 and rom.py:1206-1207: ``solve_batch`` and
    ``solve`` record every μ under their stage, a repeated μ in a fresh
    slot; ``Reductor.add_mu`` likewise."""
    from romtime_tpu_torch.rom.base import Reductor

    red = Reductor(grid=None)
    mu = dict(delta=1.0, beta=5.0)
    assert red.add_mu(step=Stage.ONLINE, mu=mu)[0] == 0
    assert red.add_mu(step=Stage.ONLINE, mu=dict(mu))[0] == 1
    assert len(red.mu_space[Stage.ONLINE]) == 2
    rom = port_hrom[0].rom
    n0 = len(rom.mu_space[Stage.VALIDATION])
    mus = [dict(MUS[0]), dict(MUS[0]), dict(MUS[1])]
    with compute_dtype_scope(torch.float64):
        rom.solve_batch(mus, step=Stage.VALIDATION, mode="probes",
                        engine="lanes")
        idx = rom.solve(dict(MUS[0]), Stage.VALIDATION)
    assert rom.mu_space[Stage.VALIDATION][n0:] == mus + [MUS[0]]
    assert idx == n0 + 3


def _drifts(solve, set_comp, f32_scope, f64_scope):
    """tests/test_hrom.py:409-440's drift of each row of ``solve()``
    ((B, nt, nh) trajectories): the float32 trajectory against the
    float64 one, relative, with the residual-form step forced off
    (False) and on its default ("auto")."""
    def rel(u32, u64):
        B = u64.shape[0]
        return (np.linalg.norm((u32 - u64).reshape(B, -1), axis=1)
                / np.linalg.norm(u64.reshape(B, -1), axis=1))

    with f64_scope():
        u64 = np.asarray(solve(), np.float64)
    drifts = {}
    for comp in (False, "auto"):
        set_comp(comp)
        try:
            with f32_scope():
                drifts[comp] = rel(np.asarray(solve(), np.float64), u64)
        finally:
            set_comp("auto")
    return drifts


#: The cell's μ for the drift comparison: the per-μ drift of a float32
#: run is a rounding-noise realization (the two packages' float32
#: trajectories sit as far from each other as from float64, and their
#: per-μ drifts differ by ±35%), so the cell's drift is the mean over
#: these 32 μ (its sampling noise ~4%).
DRIFT_MUS = piston_mus(32, seed=11)


def test_f32_drift_contract(ref_hrom, port_on_ref):
    """tests/test_hrom.py:409-440 on the parity cell, both packages on
    the same built ROM: on its μ the residual-form float32 step drifts at
    most 0.8× the plain float32 recursion from float64; over the cell
    (the mean over DRIFT_MUS through each package's vmap engine, whose
    rows are ``solve``'s) the port's drift is within 10% of the
    reference's own."""
    ref_rom, rom = ref_hrom[0].rom, port_on_ref.rom

    def port_comp(c):
        type(rom).COMPENSATED = c

    def ref_comp(c):
        type(ref_rom).COMPENSATED = c
        ref_rom._online_fns = {}

    def port_solve():
        rom.solve(MU_VAL, Stage.ONLINE)
        return rom.solutions.fom[None]

    one = _drifts(port_solve, port_comp,
                  lambda: compute_dtype_scope(torch.float32),
                  lambda: compute_dtype_scope(torch.float64))
    assert one["auto"][0] <= 0.8 * one[False][0], one
    got = _drifts(lambda: rom.solve_batch(DRIFT_MUS, mode="full",
                                          engine="vmap")["uc"],
                  port_comp, lambda: compute_dtype_scope(torch.float32),
                  lambda: compute_dtype_scope(torch.float64))
    want = _drifts(lambda: ref_rom.solve_batch(
        DRIFT_MUS, step=RefStage.ONLINE, mode="full", engine="vmap")["uc"],
        ref_comp, lambda: ref_dtype_scope(jnp.float32),
        lambda: ref_dtype_scope(jnp.float64))
    cell = {k: (float(v.mean()), float(want[k].mean()))
            for k, v in got.items()}
    assert cell["auto"][0] <= 0.8 * cell[False][0], cell
    assert abs(cell["auto"][0] - cell["auto"][1]) <= 0.1 * cell["auto"][1], (
        cell)


def _read_csv(path):
    import csv

    with open(path, newline="") as fp:
        return list(csv.reader(fp))


def _same_table(got_path, want_path, rel=1e-9):
    """Two CSV reports alike: the same header and shape; a number cell
    within ``rel`` of its column's largest magnitude, any other cell
    equal."""
    got, want = _read_csv(got_path), _read_csv(want_path)
    assert got[0] == want[0], (got_path.name, got[0], want[0])
    assert len(got) == len(want) and {len(r) for r in got} == {
        len(r) for r in want}, got_path.name

    def num(v):
        try:
            return float(v)
        except ValueError:
            return None

    for c in range(len(want[0])):
        col = [num(r[c]) for r in want[1:]]
        scale = max((abs(v) for v in col if v is not None), default=0.0)
        for r_got, r_want in zip(got[1:], want[1:]):
            a, b = num(r_got[c]), num(r_want[c])
            if b is None:
                assert r_got[c] == r_want[c], (got_path.name, c)
            else:
                assert abs(a - b) <= rel * scale + 1e-300, (
                    got_path.name, want[0][c], a, b)


def _run_evaluation(hrom, workdir, scope, rnd_seed=5):
    """``evaluate_validation`` and ``evaluate_online({"num": 2})`` in
    ``workdir`` in float64, the μ records of both stages cleared first."""
    for rom in (hrom.rom, hrom.srom):
        rom.mu_space["online"] = []
        rom.mu_space["validation"] = []
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(workdir)
        with scope():
            hrom.evaluate_validation()
            hrom.evaluate_online({"num": 2},
                                 rnd=np.random.RandomState(rnd_seed))


def test_evaluation_matches_reference(ref_hrom, port_on_ref, tmp_path):
    """tests/test_hrom.py:331-356 on the same built ROM in float64:
    ``evaluate_validation`` (the offline μ against the build's FOM
    trajectories) and ``evaluate_online({"num": 2})`` (fresh μ from the
    Mach-stratified sampler against the FOM solved for each). The ROM
    error mean under 5e-3 and a finite estimator (:349-352); each μ's
    ROM and S-ROM error series within 1e-9·scale of the reference's (the
    trajectories' scale: the RMS error moves by at most the trajectories'
    RMS gap), the estimator by tests/test_hrom.py:442-520's contract (the
    formula on the port's own trajectories, within the triangle bound of
    the two packages' trajectory gaps); the same files (solution pickles,
    probe and mass-conservation CSVs) with the reference's names, and
    each CSV's header, index and columns alike within 1e-9 of each
    column's scale."""
    from romtime_tpu_torch.utils import read_pickle

    ref, port = ref_hrom[0], port_on_ref
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_dir.mkdir()
    port_dir.mkdir()
    _run_evaluation(ref, ref_dir, lambda: ref_dtype_scope(jnp.float64))
    _run_evaluation(port, port_dir, lambda: compute_dtype_scope(
        torch.float64))
    V, Vs = port.rom.basis, port.srom.basis
    Nh = Vs.shape[0]
    for which in (Stage.VALIDATION, Stage.ONLINE):
        got, want = port.errors[which], ref.errors[which]
        assert port.errors[f"{which}-vs-fom"] is got
        assert sorted(got) == sorted(want) == list(
            range(3 if which == Stage.VALIDATION else 2))
        for idx, w in want.items():
            g = got[idx]
            assert g[Errors.ROM].mean() < 5e-3
            assert np.isfinite(g[Errors.ESTIMATOR]).all()
            sols = {}
            for kind, d in (("port", port_dir), ("ref", ref_dir)):
                for r, n in (("rom", port.rom.N), ("srom", port.srom.N)):
                    sols[kind, r] = read_pickle(
                        d / f"solutions_{r}_{n}_{which}_{idx}.pkl")
            scale = np.abs(sols["ref", "rom"].fom).max()
            for key in (Errors.ROM, Errors.SACRIFICIAL):
                assert np.abs(g[key] - w[key]).max() <= 1e-9 * scale
            uN, uNs = sols["port", "rom"].rom, sols["port", "srom"].rom
            same = np.array([compute_rom_difference(uN[:, i], uNs[:, i], Vs)
                             for i in range(uN.shape[1])])
            np.testing.assert_allclose(g[Errors.ESTIMATOR], same,
                                       rtol=1e-10, atol=1e-17)
            noise = (np.linalg.norm(V @ (uN - sols["ref", "rom"].rom), axis=0)
                     + np.linalg.norm(Vs @ (uNs - sols["ref", "srom"].rom),
                                      axis=0)) / np.sqrt(Nh)
            e_ref = np.asarray(w[Errors.ESTIMATOR])
            assert np.all(np.abs(g[Errors.ESTIMATOR] - e_ref)
                          <= noise + 1e-12 * e_ref + 1e-16)
    names = sorted(p.name for p in port_dir.iterdir())
    assert names == sorted(p.name for p in ref_dir.iterdir())
    csvs = [n for n in names if n.endswith(".csv")]
    assert len(csvs) == 3 * 2 + 2 * 5, csvs
    for n in csvs:
        _same_table(port_dir / n, ref_dir / n)
    # dump_errors: the reference's table of series, numpy-printed cells.
    for d, h in ((port_dir, port), (ref_dir, ref)):
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(d)
            h.dump_errors(Stage.VALIDATION)
    name = f"errors_{Stage.VALIDATION}.csv"
    got, want = _read_csv(port_dir / name), _read_csv(ref_dir / name)
    assert got[0] == want[0] and [r[0] for r in got] == [r[0] for r in want]
    for row in got[1:]:
        for j, cell in enumerate(row[1:]):
            series = port.errors[Stage.VALIDATION][int(got[0][j + 1])][row[0]]
            np.testing.assert_allclose(
                np.array(cell.strip("[]").split(), float), series, rtol=1e-7)
    with pytest.raises(Warning):
        port.dump_errors("nothing", path=str(tmp_path))


def test_evaluate_deim_and_summary(ref_hrom, port_hrom, port_on_ref,
                                  tmp_path):
    """``evaluate_deim`` and ``generate_summary`` (reference
    hrom.py:1261-1368) on the same built ROM: every reductor's
    interpolation errors on the offline μ within 1e-6 of the series'
    largest value of the reference's, plus 1e-14 of the operator's
    largest entry (the two packages' float64 assemblies of an operator
    and of its interpolant agree to ~1e-16 of the operator; an operator
    its reductor interpolates exactly shows errors at that rounding); the
    summary's basis table as the reference's DataFrame (rows, columns,
    values), its per-operator spectra, energies, DEIM errors and μ
    spaces; ``dump_errors_deim``, ``dump_errors``, ``dump_setup`` and
    ``dump_validation_fom`` write the reference's files."""
    import json

    ref, port = ref_hrom[0], port_on_ref
    # A resumed N-MDEIM has no ψ states (the reference's too); the built
    # pipeline's are its ROM basis, the same basis here.
    port.mdeim_trilinear.u_n = np.asarray(ref.mdeim_trilinear.u_n)
    with ref_dtype_scope(jnp.float64):
        ref.evaluate_deim()
    with compute_dtype_scope(torch.float64):
        port.evaluate_deim()
    for attr in ("deim_rhs", "mdeim_mass", "mdeim_stiffness",
                 "mdeim_convection", "mdeim_trilinear_lifting",
                 "mdeim_trilinear"):
        got, want = getattr(port, attr), getattr(ref, attr)
        assert sorted(got.errors_rom) == sorted(want.errors_rom), attr
        if attr == "mdeim_trilinear":
            floor = 0.0
        else:
            with compute_dtype_scope(torch.float64):
                floor = 1e-14 * np.abs(got.assemble_snapshot(
                    port.mu_space[Stage.OFFLINE][0], 0.3)).max()
        for idx, w in want.errors_rom.items():
            w = np.asarray(w)
            np.testing.assert_allclose(got.errors_rom[idx], w, rtol=0,
                                       atol=1e-6 * np.abs(w).max() + floor,
                                       err_msg=attr)
    # The summary reads the tree walks' reports, which only a build
    # writes: the port's own build against the reference's.
    built = port_hrom[0]
    ref.generate_summary()
    built.generate_summary()
    port.generate_summary()
    table = ref.summary_basis
    assert built.summary_basis["index"] == list(table.index)
    for col in table.columns:
        assert built.summary_basis[col] == list(table[col]), col
    assert built.summary_errors["index"] == list(ref.summary_errors.index)
    for h in (built, port):
        assert sorted(h.summary_errors_deim) == sorted(
            ref.summary_errors_deim)
        assert sorted(h.mu_space_deim) == sorted(ref.mu_space_deim)
    for name, errors in ref.summary_errors_deim.items():
        assert sorted(port.summary_errors_deim[name]) == sorted(errors)
    for name, spectra in ref.summary_sigmas.items():
        for key, v in spectra.items():
            assert np.asarray(built.summary_sigmas[name][key]).shape == (
                np.asarray(v).shape), name
    dumps = {}
    for kind, h, scope in (("ref", ref, lambda: ref_dtype_scope(jnp.float64)),
                           ("port", port, lambda: compute_dtype_scope(
                               torch.float64))):
        d = tmp_path / kind
        d.mkdir()
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(d)
            h.dump_errors_deim()
            h.dump_setup(None)
            h.dump_validation_fom()
        dumps[kind] = d
    names = sorted(p.name for p in dumps["port"].iterdir())
    assert names == sorted(p.name for p in dumps["ref"].iterdir())
    by_file = {f"errors_deim_{name.lower()}.csv": errors
               for name, errors in port.summary_errors_deim.items()}
    for n in names:
        if n.endswith(".csv"):
            # The reference's layout; the port's own series, exactly.
            got, want = (_read_csv(dumps[k] / n) for k in ("port", "ref"))
            assert got[0] == want[0] and [r[0] for r in got] == [
                r[0] for r in want], n
            series = by_file[n]
            for j, idx in enumerate(series):
                np.testing.assert_array_equal(
                    [float(r[j + 1]) for r in got[1:]], series[idx])
    with open(dumps["port"] / StorageNames.SETUP) as fp:
        setup = json.load(fp)
    with open(dumps["ref"] / StorageNames.SETUP) as fp:
        assert setup == json.load(fp)


def test_deim_nh_and_compute_thetas(ref_hrom, port_on_ref):
    """deim.py:153-155 and :379-381: every reductor's ``Nh`` is its
    collateral basis's rows, the reference's; ``compute_thetas`` solves
    PᵀU θ = f|dofs in float64."""
    ref, port = ref_hrom[0], port_on_ref
    rng = np.random.default_rng(3)
    for attr in REDUCTORS:
        got, want = getattr(port.rom, attr), getattr(ref.rom, attr)
        assert got.Nh == want.Nh == got.basis_fom.shape[0]
        theta = rng.normal(size=got.N)
        np.testing.assert_allclose(
            got.compute_thetas(got.PT_U @ theta), theta, rtol=0,
            atol=1e-10 * np.abs(theta).max() * np.linalg.cond(got.PT_U))
