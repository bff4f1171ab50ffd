"""The port's offline build (romtime_tpu_torch/rom/hrom.py
``HyperReducedPiston``, rom/rom.py's build half, rom/engines/global_fused
``GlobalServing.from_rom``) against the JAX package's, on the conftest
piston pipeline (tests/conftest.py:50-104: nx=150, nt=96, tf=0.6, 3
offline μ from the Mach-stratified sampler with RandomState(0), S-ROM
truncated by 2, N-MDEIM kept to 10 modes, all six operator models), each
package building its own in a temporary directory, in float64; the
reference's through tests/torch_parity.build_piston_hrom (its SVD routed
through numpy).

Anchors: tests/test_hrom.py (the piston pipeline, its dumps and
``start_from_existing_basis``, tests/test_hrom.py:190, and the estimator's
three-part contract, :442-520), tests/test_rom.py (``truncate``, the
served engines at :196-200 and :226-227) and
tests/test_pod_weighting.py (the σ-weighted tree walk). Limits:

- the offline μ identical; the ROM and S-ROM projectors VVᵀ within
  1e-9 (singular vectors carry arbitrary signs: V itself differs);
- every reductor's dofs equal by tests/test_torch_deim_train
  .assert_same_dofs (equal, or the same set, or a tie up to rounding);
- T0 built by the port on the reference's V within 1e-12·max|T0| of the
  reference's ``_trilinear_state_table``;
- the port-built ROM's float64 lanes probes within 1e-9·scale of the
  reference ROM's (its reduced sweep's probes, equal to its
  ``mode="probes"`` sweep at 1e-14, tests/test_rom.py:161), the
  reconstructed final states V·uN likewise;
- the estimator by the three-part contract on basis-invariant
  reconstructions: the formula on the port's own trajectories (rtol
  1e-10), the reconstructed trajectories of the two packages within
  1e-9·scale, the estimators within the triangle bound of those gaps. The
  estimators differ by ~2e-8 of their size (not 1e-9): the S-ROM's
  trailing modes, near the POD's drop floor, move by ~5e-10 between two
  float64 FOM sweeps that differ by rounding, and the estimator is a
  difference of two trajectories that agree to ~1e-8;
- served on the CPU twins of K4 and K5 (``engine="pallas"``, float32)
  within 3e-5·scale of the float64 lanes engine and K5 within 3e-6·scale
  of K4 (tests/test_rom.py:196-200, :226-227);
- ``start_from_existing_basis`` resumes the port from the reference's
  pickles and the reference from the port's.
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romtime_tpu.conventions import Stage as RefStage
from romtime_tpu.dtypes import compute_dtype_scope as ref_dtype_scope
from romtime_tpu_torch.conventions import (
    Errors,
    OperatorType,
    PistonParameters,
    RomParameters,
    Stage,
    StorageNames,
)
from romtime_tpu_torch.dtypes import compute_dtype_scope
from romtime_tpu_torch.parameters import get_uniform_dist
from romtime_tpu_torch.problems import define_piston_problem
from romtime_tpu_torch.rom import RomConstructorNonlinear
from romtime_tpu_torch.rom.hrom import HyperReducedPiston
from romtime_tpu_torch.utils import compute_rom_difference
from test_torch_deim_train import assert_same_dofs
from torch_parity import _numpy_svd, build_piston_hrom, piston_mus

jax.config.update("jax_enable_x64", True)

#: The ROM's reductor attributes (both packages).
REDUCTORS = ("mdeim_Mh", "mdeim_Ah", "deim_rhs", "mdeim_Ch", "mdeim_Nh_hat",
             "mdeim_Nh")
MUS = piston_mus(3, seed=5)


def port_setup(device="cpu"):
    """The conftest pipeline's configuration (tests/conftest.py:50-104)
    with the port's problem callables and distributions."""
    L, nx, nt, tf = 1.0, 150, 96, 0.6
    domain, bcs, forcing, u0, Lt, dLt_dt = define_piston_problem(
        L=L, nx=nx, tf=tf, nt=nt)
    grid = {
        PistonParameters.A0: get_uniform_dist(min=8.0, max=10.0),
        PistonParameters.OMEGA: get_uniform_dist(min=15.0, max=20.0),
        PistonParameters.DELTA: get_uniform_dist(min=0.1, max=0.15),
        PistonParameters.ALPHA: get_uniform_dist(min=1e-6, max=1e-6),
        PistonParameters.GAMMA: get_uniform_dist(min=1.4, max=1.4),
    }
    ts = np.linspace(tf / nt, tf, nt)
    deim_params = {RomParameters.TS: ts, RomParameters.NUM_SNAPSHOTS: 3}
    return dict(
        grid=grid,
        fom_params=dict(domain=domain, dirichlet=bcs, forcing_term=forcing,
                        u0=u0, Lt=Lt, dLt_dt=dLt_dt,
                        grid_params={k: "uniform" for k in grid}),
        rom_params={RomParameters.NUM_SNAPSHOTS: 3,
                    RomParameters.SROM_TRUNCATE: 2,
                    RomParameters.TOL_TIME: None, RomParameters.TOL_MU: None,
                    RomParameters.NMDEIM_SIZE: 10},
        deim_params=deim_params, mdeim_params=dict(deim_params),
        mdeim_nonlinear_params={RomParameters.TS: ts[:: max(1, nt // 24)],
                                RomParameters.NUM_SNAPSHOTS: 2},
        models={k: True for k in (
            OperatorType.MASS, OperatorType.STIFFNESS, OperatorType.RHS,
            OperatorType.CONVECTION, OperatorType.NONLINEAR_LIFTING,
            OperatorType.TRILINEAR)},
        rnd=np.random.RandomState(0), device=device)


def port_build(workdir, device_sweep=False, device="cpu"):
    """bench.py's offline sequence (bench.py:209-262) with the port, in
    ``workdir``, and the dumps."""
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        hrom = HyperReducedPiston(**port_setup(device))
        hrom.setup()
        hrom.setup_hyperreduction()
        hrom.run_offline_rom(device_sweep=device_sweep)
        hrom.run_offline_hyperreduction(
            mu_space=hrom.mu_space[Stage.OFFLINE], evaluate=False)
        hrom.project_reductors()
        hrom.dump_mu_space()
        hrom.dump_reduced_basis()
        hrom.dump_offline_snapshots()
    finally:
        os.chdir(cwd)
    return hrom


@pytest.fixture(scope="module")
def ref_hrom(tmp_path_factory):
    """The reference's pipeline, its μ space and bases dumped beside its
    reductor pickles, and its global estimate on MUS (its SVD through
    numpy)."""
    workdir = tmp_path_factory.mktemp("ref_build")
    hrom = build_piston_hrom(workdir)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(workdir)
        mp.setattr(jnp.linalg, "svd", _numpy_svd)
        hrom.dump_mu_space()
        hrom.dump_reduced_basis()
        with ref_dtype_scope(jnp.float64):
            est = hrom.estimate_batch([dict(m) for m in MUS],
                                      step=RefStage.ONLINE)
    return hrom, workdir, est


@pytest.fixture(scope="module")
def port_hrom(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("port_build")
    return port_build(workdir), workdir


def _projector(V):
    V = np.asarray(V)
    return V @ V.T


def _port_est(hrom):
    with compute_dtype_scope(torch.float64):
        out = hrom.estimate_batch([dict(m) for m in MUS])
    return dict(out, **{k: {key: v.movedim(-1, 0).numpy()
                            for key, v in out[k].items()}
                        for k in ("rom", "srom")})


def test_offline_mu_and_bases(ref_hrom, port_hrom):
    """The same three offline μ (Mach-stratified, sorted, tagged with
    their Mach number); ROM and S-ROM of the same size with projectors
    within 1e-9; the nonlinear basis spanning the same space; the report
    and the build's precision tag."""
    ref, port = ref_hrom[0], port_hrom[0]
    assert port.mu_space[Stage.OFFLINE] == ref.mu_space[Stage.OFFLINE]
    assert len(port.mu_space[Stage.OFFLINE]) == 3
    assert all(PistonParameters.MACH_PISTON in m
               for m in port.mu_space[Stage.OFFLINE])
    for got, want in ((port.rom, ref.rom), (port.srom, ref.srom)):
        assert got.basis.shape == np.asarray(want.basis).shape
        np.testing.assert_allclose(_projector(got.basis),
                                   _projector(want.basis), rtol=0, atol=1e-9)
        np.testing.assert_allclose(got.basis.T @ got.basis,
                                   np.eye(got.N), rtol=0, atol=1e-12)
    assert port.srom.N - port.rom.N == 2
    k = 10
    np.testing.assert_allclose(_projector(port.srom.basis_nonlinear[:, :k]),
                               _projector(np.asarray(
                                   ref.srom.basis_nonlinear)[:, :k]),
                               rtol=0, atol=1e-9)
    rep, ref_rep = (h.srom.report[Stage.OFFLINE] for h in (port, ref))
    for key in ("basis-shape-after-tree-walk", "basis-shape-final",
                "N-basis-shape-final"):
        assert rep[key] == ref_rep[key]
    assert port.srom.offline_snapshots_build == "f64"
    assert len(port.srom.offline_snapshots) == 3


@pytest.mark.parametrize("attr", REDUCTORS)
def test_reductor_dofs(ref_hrom, port_hrom, attr):
    """Every reductor of the ROM (the S-ROM holds the same ones): its
    dofs, and its collateral basis spanning the reference's."""
    ref, port = ref_hrom[0], port_hrom[0]
    got, want = getattr(port.rom, attr), getattr(ref.rom, attr)
    assert got.N == want.N
    assert_same_dofs(got, want)
    np.testing.assert_allclose(_projector(got.basis_fom),
                               _projector(want.basis_fom), rtol=0, atol=1e-9)
    assert getattr(port.srom, attr).dofs == got.dofs


def test_trilinear_table(ref_hrom, port_hrom, monkeypatch):
    """T0 on the reference's basis: the port's exact N-column table
    within 1e-12·max|T0| of the reference's; the port's own table passes
    the scale-invariance probe; ``ROMTIME_TRI_TABLE=deim`` gives the
    N-MDEIM reconstruction basis_rom·PᵀU⁻¹·E0."""
    ref, port = ref_hrom[0], port_hrom[0]
    V = np.asarray(ref.rom.basis)
    want = np.asarray(ref.rom._trilinear_state_table(V))
    mu_a = dict(port.rom.mu_space[Stage.OFFLINE][0])
    got = port.rom._trilinear_exact_columns(
        V, mu_a, port.fom.nonlinear_coefficient(mu_a))
    assert got.shape == want.shape == (V.shape[1] ** 2, V.shape[1])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    own = port.rom._trilinear_state_table(port.rom.basis)
    assert own is not None and np.isfinite(own).all()
    monkeypatch.setenv("ROMTIME_TRI_TABLE", "deim")
    red, fom, V = port.rom.mdeim_Nh, port.fom, port.rom.basis
    deim = port.rom._build_trilinear_state_table(V)
    f64 = torch.float64
    E0 = fom.assemble_trilinear(
        mu={k: torch.tensor(float(v), dtype=f64) for k, v in mu_a.items()},
        t=torch.tensor(0.37 * fom.domain[fom.T], dtype=f64),
        u_n=(V, torch.eye(V.shape[1], dtype=f64)),
        entries=red.dofs).numpy() / fom.nonlinear_coefficient(mu_a)
    assert deim.shape == own.shape
    np.testing.assert_allclose(deim, red.basis_rom @ (red.PT_U_inv @ E0),
                               rtol=0, atol=1e-12 * np.abs(deim).max())


def test_lanes_probes_and_estimator(ref_hrom, port_hrom):
    """The port-built ROM and S-ROM certify MUS in float64 on the global
    lanes engine: probes and reconstructed states against the reference
    ROM's, the estimator by the three-part contract
    (tests/test_hrom.py:442-520) on reconstructions."""
    ref, est_ref = ref_hrom[0], ref_hrom[2]
    port = port_hrom[0]
    assert port.rom._resolve_engine("reduced", len(MUS)) == "lanes"
    est = _port_est(port)
    uN, uNs = est["rom"]["uN"], est["srom"]["uN"]
    probes_ref = np.asarray(est_ref["rom"]["probes"])
    scale = np.abs(probes_ref).max()
    assert np.abs(est["rom"]["probes"] - probes_ref).max() <= 1e-9 * scale

    V, Vs = port.rom.basis, port.srom.basis
    Vr, Vsr = np.asarray(ref.rom.basis), np.asarray(ref.srom.basis)
    u_rom = np.einsum("hn,btn->bth", V, uN)
    u_srom = np.einsum("hn,btn->bth", Vs, uNs)
    u_rom_ref = np.einsum("hn,btn->bth", Vr, np.asarray(est_ref["rom"]["uN"]))
    u_srom_ref = np.einsum("hn,btn->bth", Vsr,
                           np.asarray(est_ref["srom"]["uN"]))
    e, e_ref = est[Errors.ESTIMATOR], np.asarray(est_ref[Errors.ESTIMATOR])
    assert e.shape == e_ref.shape == (3, 96)
    assert np.isfinite(e).all() and (e >= 0).all()
    Nh = Vs.shape[0]
    for b in range(len(MUS)):
        same = np.array([compute_rom_difference(uN[b, i], uNs[b, i], Vs)
                         for i in range(uN.shape[1])])
        np.testing.assert_allclose(e[b], same, rtol=1e-10, atol=1e-17)
        d_rom = np.linalg.norm(u_rom[b] - u_rom_ref[b], axis=1)
        d_srom = np.linalg.norm(u_srom[b] - u_srom_ref[b], axis=1)
        scale = max(np.linalg.norm(u_rom_ref[b], axis=1).max(),
                    np.linalg.norm(u_srom_ref[b], axis=1).max())
        assert d_rom.max() <= 1e-9 * scale
        assert d_srom.max() <= 1e-9 * scale
        noise = (d_rom + d_srom) / np.sqrt(Nh)
        gap = np.abs(e[b] - e_ref[b])
        assert np.all(gap <= noise + 1e-12 * e_ref[b] + 1e-16)
        resolved = e_ref[b] > 20.0 * noise
        if resolved.any():
            np.testing.assert_allclose(e[b][resolved], e_ref[b][resolved],
                                       rtol=0.1)


def test_served_kernels_on_the_built_rom(port_hrom):
    """``engine="pallas"`` on the port-built ROM (N=35; the CPU twins of
    K4 and, with the budget at 0, K5): probes within 3e-5·scale and
    ``uN_final`` within 1e-4·max(|uN|, 1) of the float64 lanes engine,
    K5 within 3e-6·scale of K4 (tests/test_rom.py:196-200, :226-227)."""
    rom = port_hrom[0].rom
    with compute_dtype_scope(torch.float64):
        lanes = rom.solve_batch(MUS, mode="probes", engine="lanes")
    k4 = rom.solve_batch(MUS, mode="probes", engine="pallas")
    rom.ONLINE_PRECOMPUTE_BUDGET = 0
    try:
        k5 = rom.solve_batch(MUS, mode="probes", engine="pallas")
    finally:
        del rom.ONLINE_PRECOMPUTE_BUDGET
    scale = np.abs(lanes["probes"]).max()
    uscale = max(np.abs(lanes["uN_final"]).max(), 1.0)
    for out in (k4, k5):
        assert np.isfinite(out["probes"]).all()
        assert np.abs(out["probes"] - lanes["probes"]).max() <= 3e-5 * scale
        assert np.abs(out["uN_final"] - lanes["uN_final"]).max() <= (
            1e-4 * uscale)
    assert np.abs(k5["probes"] - k4["probes"]).max() <= 3e-6 * scale


def test_device_sweep_matches_serial(port_hrom, tmp_path):
    """``run_offline_rom(device_sweep=True)`` (one ``solve_fom_batch``)
    against the serial ``fom.solve()`` per μ: the snapshots within
    1e-12 relative, the same bases and dofs; the serial path alone writes
    the probe CSVs."""
    serial, serial_dir = port_hrom
    batch = port_build(tmp_path, device_sweep=True)
    for a, b in zip(batch.srom.offline_snapshots,
                    serial.srom.offline_snapshots):
        assert np.linalg.norm(a - b) <= 1e-12 * np.linalg.norm(b)
    np.testing.assert_allclose(_projector(batch.srom.basis),
                               _projector(serial.srom.basis), rtol=0,
                               atol=1e-10)
    for attr in REDUCTORS:
        assert sorted(getattr(batch.rom, attr).dofs) == sorted(
            getattr(serial.rom, attr).dofs)
    assert sorted(p.name for p in serial_dir.glob("probes_offline_fom_*"))\
        == [f"probes_offline_fom_{i}.csv" for i in range(3)]
    assert not list(tmp_path.glob("probes_offline_fom_*"))


def test_dumps_as_the_reference_writes_them(ref_hrom, port_hrom):
    """The same files under the same names: the μ space (JSON), the
    bases (pickled numpy), every reductor's collateral basis, the
    offline snapshots with their build tag."""
    ref_dir, (port, port_dir) = ref_hrom[1], port_hrom
    names = {p.name for p in port_dir.iterdir()}
    ref_names = {p.name for p in ref_dir.iterdir()
                 if p.suffix in (".pkl", ".json")}
    assert ref_names <= names
    with open(port_dir / StorageNames.MU_SPACE) as fp:
        assert json.load(fp)[Stage.OFFLINE] == [
            {k: float(v) for k, v in m.items()}
            for m in port.mu_space[Stage.OFFLINE]]
    for name, want in ((StorageNames.ROM, port.rom.basis),
                       (StorageNames.SROM, port.srom.basis)):
        with open(port_dir / name, "rb") as fp:
            got = pickle.load(fp)
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, want)
    with np.load(port_dir / StorageNames.SNAPSHOTS) as data:
        assert str(data["__build__"]) == "f64"
        assert sorted(data.files) == ["__build__", "s0", "s1", "s2"]


def test_port_resumes_from_reference_pickles(ref_hrom, monkeypatch):
    """tests/test_hrom.py:190 across packages: the port's pipeline resumes
    in the reference's directory from its pickles — the same bases bit
    for bit, each reductor's collateral basis, the windows — and its
    float64 lanes probes meet the reference ROM's within 1e-9·scale."""
    ref, ref_dir, est_ref = ref_hrom
    monkeypatch.chdir(ref_dir)
    port = HyperReducedPiston(**port_setup())
    port.setup()
    port.setup_hyperreduction()
    port.start_from_existing_basis()
    port.project_reductors()
    np.testing.assert_array_equal(port.srom.basis, np.asarray(ref.srom.basis))
    np.testing.assert_array_equal(port.rom.basis, np.asarray(ref.rom.basis))
    assert port.mu_space[Stage.OFFLINE] == [
        {k: float(v) for k, v in m.items()}
        for m in ref.mu_space[Stage.OFFLINE]]
    for attr in REDUCTORS:
        got, want = getattr(port.rom, attr), getattr(ref.rom, attr)
        np.testing.assert_array_equal(got.basis_fom,
                                      np.asarray(want.basis_fom))
        assert_same_dofs(got, want)
    assert port.rom.windows is not None
    assert port.rom.windows.N == ref.rom.windows.N
    with compute_dtype_scope(torch.float64):
        out = port.rom.solve_batch([dict(m) for m in MUS], mode="probes",
                                   engine="lanes")
    want = np.asarray(est_ref["rom"]["probes"])
    assert np.abs(out["probes"] - want).max() <= 1e-9 * np.abs(want).max()
    np.testing.assert_allclose(out["uN_final"],
                               np.asarray(est_ref["rom"]["uN"])[:, -1],
                               rtol=0, atol=1e-9 * max(np.abs(
                                   out["uN_final"]).max(), 1.0))


def test_reference_resumes_from_port_pickles(port_hrom, monkeypatch):
    """The other way: the reference's pipeline resumes in the port's
    directory from its pickles — the port's bases, its reductors'
    collateral bases — and its trilinear table on that basis equals the
    port's (1e-12·max|T0|)."""
    from conftest import _piston_windowed_setup
    from romtime_tpu.rom.hrom import HyperReducedPiston as RefHRP

    port, port_dir = port_hrom
    monkeypatch.chdir(port_dir)
    monkeypatch.setattr(jnp.linalg, "svd", _numpy_svd)
    ref = RefHRP(**_piston_windowed_setup(), rnd=np.random.RandomState(0))
    ref.setup()
    ref.setup_hyperreduction()
    ref.start_from_existing_basis()
    ref.project_reductors()
    np.testing.assert_array_equal(np.asarray(ref.rom.basis), port.rom.basis)
    for attr in REDUCTORS:
        got, want = getattr(port.rom, attr), getattr(ref.rom, attr)
        np.testing.assert_array_equal(np.asarray(want.basis_fom),
                                      got.basis_fom)
        assert_same_dofs(got, want)
    T0 = np.asarray(ref.rom._trilinear_state_table(np.asarray(ref.rom.basis)))
    own = port.rom._trilinear_state_table(port.rom.basis)
    np.testing.assert_allclose(own, T0, rtol=0, atol=1e-12 * np.abs(T0).max())


def test_constructor_forms(port_hrom):
    """The reference's forms build (``RomConstructorNonlinear(fom=…,
    grid=…, name=…)``, the pipeline's keywords) on the card unless the
    caller asks for the CPU; the artifact forms serve the global
    configuration of a built ROM."""
    import inspect

    from romtime_tpu_torch.rom.engines.global_fused import GlobalServing

    for fn in (RomConstructorNonlinear, HyperReducedPiston,
               RomConstructorNonlinear.from_artifacts):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    port = port_hrom[0]
    rom = port.rom
    assert rom.grid == {k: (min(v.support()), max(v.support()))
                        for k, v in rom.sampling_grid.items()}
    gs = rom.global_serving
    assert isinstance(gs, GlobalServing) and gs.N == rom.N
    served = RomConstructorNonlinear.from_artifacts(
        rom.fom, rom.reductors, device="cpu",
        global_serving=GlobalServing.from_arrays(gs.to_arrays()),
        grid=rom.grid)
    est = HyperReducedPiston.from_serving(rom, srom=port.srom)
    with compute_dtype_scope(torch.float64):
        a = served.solve_batch(MUS[:2], mode="probes", engine="lanes")
        b = rom.solve_batch(MUS[:2], mode="probes", engine="lanes")
        e = est.estimate_batch(MUS[:2])
    np.testing.assert_array_equal(a["probes"], b["probes"])
    assert e[Errors.ESTIMATOR].shape == (2, 96)
