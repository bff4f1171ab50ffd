"""The port's examples (romtime_tpu_torch/examples/), its convergence
study and golden table (romtime_tpu_torch/scripts/mpf1_convergence.py,
generate_goldens.py) and the graft entry
(romtime_tpu_torch/parallel/dryrun.py ``entry``) against the JAX
originals on the CPU: examples/poisson_tutorial.py, examples/heat_2d.py,
examples/piston_rom.py, scripts/mpf1_convergence.py,
tests/goldens/heat_hrom_online_stats.json (scripts/generate_goldens.py)
and __graft_entry__.py:46. The piston stages run on the conftest piston
pipeline (tests/conftest.py:50-104, built once per run by
``torch_parity.build_piston_hrom``) resumed by the port from its pickles.
Also: every new module imports with JAX, the JAX package and pandas
blocked, and each entry point raises without a card unless given
``--device cpu``.

Several outputs of the examples are rounding noise by design (the
Poisson error against the interpolant, the 2-D heat error against u_e,
POD's σ₂/σ₁): those are held within 1e-12 of the solution's scale, the
solutions themselves within 1e-12 relative.
"""

import csv
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romtime_tpu.conventions import Errors as RefErrors
from romtime_tpu.conventions import Stage as RefStage
from romtime_tpu_torch.conventions import Errors, Stage
from romtime_tpu_torch.dtypes import compute_dtype_scope
from romtime_tpu_torch.examples import heat_2d, piston_rom, poisson_tutorial
from romtime_tpu_torch.parallel import dryrun
from romtime_tpu_torch.rom.hrom import HyperReducedPiston
from romtime_tpu_torch.scripts import generate_goldens, mpf1_convergence
from romtime_tpu_torch.utils import compute_rom_difference
from test_torch_estimator import _contract, _host
from test_torch_offline_build import port_setup
from torch_parity import _numpy_svd, build_piston_hrom

jax.config.update("jax_enable_x64", True)

REPO = Path(__file__).resolve().parents[1]
#: The goldens' heat configuration: tf to 99% decay at β = 5
#: (tests/test_convergence_goldens.py).
GOLDEN_TF = float(-np.log(1.0 - 0.99) / 5.0)


def jax_module(relpath, name):
    """A JAX-repo example or script imported from its file."""
    spec = importlib.util.spec_from_file_location(name, REPO / relpath)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_poisson_matches_jax_example(monkeypatch):
    """examples/poisson_tutorial.py:34-47 ``solve_poisson`` at nx 16 and
    64 (α = 1) and :62-84's POD family: the solutions within 1e-12
    relative, the L2 errors against the interpolant within 1e-12 of the
    solution's scale, one POD mode, its basis vector equal up to sign
    (1e-12) and the unseen-α reconstruction exact (≤ 1e-12)."""
    ref = jax_module("examples/poisson_tutorial.py", "jax_poisson_tutorial")
    from romtime_tpu.ops import interpolate_dofs, norm_L2
    from romtime_tpu.rom.pod import orth as ref_orth

    got = poisson_tutorial.certify("cpu", grids=(16, 64))
    for nx, (u, err) in got.items():
        mesh, u_ref = ref.solve_poisson(nx, alpha=1.0)
        u_ref = np.asarray(u_ref)
        scale = np.abs(u_ref).max()
        np.testing.assert_allclose(u, u_ref, rtol=0, atol=1e-12 * scale)
        ue = interpolate_dofs(lambda x: jnp.sin(jnp.pi * x), mesh)
        err_ref = float(norm_L2(jnp.asarray(u_ref) - ue, mesh))
        assert abs(err - err_ref) <= 1e-12 * scale
        assert err <= 1e-12

    pod = poisson_tutorial.pod_family("cpu")
    # The family's snapshots: the port's (held at one α against the JAX
    # example's) through both packages' POD. The family is rank 1: route
    # the JAX package's SVD through numpy (the jax CPU SVD fault on
    # rank-1 matrices, ROADMAP Queue 3).
    nx, alpha = poisson_tutorial.FAMILY_NX, poisson_tutorial.UNSEEN_ALPHA
    u_ref = np.asarray(ref.solve_poisson(nx, alpha)[1])
    np.testing.assert_allclose(
        poisson_tutorial.solve_poisson(nx, alpha, "cpu")[1].numpy(), u_ref,
        rtol=0, atol=1e-12 * np.abs(u_ref).max())
    monkeypatch.setattr(jnp.linalg, "svd", _numpy_svd)
    snaps = np.array([poisson_tutorial.solve_poisson(nx, float(a), "cpu")[1]
                      .numpy() for a in poisson_tutorial.FAMILY_ALPHAS]).T
    basis_ref, sigmas_ref, _ = ref_orth(snaps)
    basis_ref = np.asarray(basis_ref)
    assert pod["basis"].shape == basis_ref.shape == (snaps.shape[0], 1)
    sign = np.sign(pod["basis"][:, 0] @ basis_ref[:, 0])
    np.testing.assert_allclose(pod["basis"], sign * basis_ref, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(pod["sigmas"][0], np.asarray(sigmas_ref)[0],
                               rtol=1e-12)
    assert pod["reconstruction_rel"] <= 1e-12


def test_heat_2d_matches_jax_example():
    """examples/heat_2d.py:48-100 ``solve_heat_2d(nx=16, nt=20)``: the
    error series within 1e-12 of the field's scale of the JAX example's,
    both at solver precision, and the final field within 1e-12 relative
    of u_e at tf (the JAX example returns no field)."""
    ref = jax_module("examples/heat_2d.py", "jax_heat_2d")
    ts, errors, u = heat_2d.solve_heat_2d(nx=16, nt=20, device="cpu")
    ts_ref, errors_ref = ref.solve_heat_2d(nx=16, nt=20)
    np.testing.assert_allclose(ts, ts_ref, rtol=1e-15)
    x = np.linspace(0.0, 1.0, 17)
    X, Y = np.meshgrid(x, x, indexing="ij")
    exact = 1.0 + X ** 2 + 1.2 * Y ** 2 + 3.0 * ts[-1]
    scale = np.abs(exact).max()
    np.testing.assert_allclose(u, exact, rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(errors, errors_ref, rtol=0,
                               atol=1e-12 * scale)
    assert errors.max() <= 1e-12 * scale


@pytest.mark.parametrize("moving", [False, True])
def test_mpf1_convergence_rows_match_jax_script(moving, tmp_path,
                                                monkeypatch):
    """scripts/mpf1_convergence.py:21-84 at nx=100, nts 10 and 50, on the
    goldens' tf (99% decay): the CSV header equals the JAX script's and
    every row's log10 error is within 1e-8 of its (the precedent of
    tests/test_torch_heat.py); dt equal, the rates printed from the same
    errors."""
    ref = jax_module("scripts/mpf1_convergence.py", "jax_mpf1_convergence")
    ref_csv, port_csv = tmp_path / "jax.csv", tmp_path / "port.csv"
    argv = ["--nx", "100", "--nts", "10", "50", "--tf", repr(GOLDEN_TF)]
    argv += ["--moving"] if moving else []
    monkeypatch.setattr(sys, "argv",
                        ["mpf1_convergence.py", *argv, "--csv", str(ref_csv)])
    ref.main()
    rows = mpf1_convergence.main(argv + ["--device", "cpu", "--csv",
                                         str(port_csv)])
    with open(ref_csv) as fh:
        want = list(csv.DictReader(fh))
    with open(port_csv) as fh:
        header = next(csv.reader(fh))
    assert tuple(header) == mpf1_convergence.COLUMNS
    assert header == list(want[0].keys())
    assert [r["nt"] for r in rows] == [int(r["nt"]) for r in want]
    for r, w in zip(rows, want):
        assert r["dt"] == pytest.approx(float(w["dt"]), rel=1e-15)
        assert abs(r["log10_error"] - float(w["log10_error"])) <= 1e-8
    assert np.all(np.isfinite(mpf1_convergence.observed_rates(rows)))


def _constructor_arguments(ref, monkeypatch, tmp_path):
    captured = {}

    def record(**kw):
        captured.update(kw)
        return kw

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(ref, "HyperReducedPiston", record)
    ref.build_pipeline(nx=60, nt=90)
    return captured


def test_piston_pipeline_arguments_match_jax_example(tmp_path, monkeypatch):
    """examples/piston_rom.py:40-90 ``build_pipeline``'s constructor
    arguments (nx=60, nt=90, no build) against the port's
    ``pipeline_arguments``: the μ box, the FOM domain, the ROM, DEIM,
    MDEIM and N-MDEIM parameters, the models and the sampler's state."""
    ref = jax_module("examples/piston_rom.py", "jax_piston_rom")
    want = _constructor_arguments(ref, monkeypatch, tmp_path)
    got = piston_rom.pipeline_arguments(nx=60, nt=90, device="cpu")
    assert got.pop("device") == "cpu"
    assert set(got) == set(want)
    assert list(got["grid"]) == list(want["grid"])
    for k, d in got["grid"].items():
        assert (min(d.support()), max(d.support())) == (
            min(want["grid"][k].support()), max(want["grid"][k].support()))
    fp, fp_ref = got["fom_params"], want["fom_params"]
    assert set(fp) == set(fp_ref)
    assert fp["domain"] == fp_ref["domain"]
    assert fp["grid_params"] == fp_ref["grid_params"]
    assert got["rom_params"] == want["rom_params"]
    for key in ("deim_params", "mdeim_params", "mdeim_nonlinear_params"):
        assert set(got[key]) == set(want[key])
        for k, v in got[key].items():
            np.testing.assert_array_equal(v, want[key][k])
    assert got["models"] == want["models"]
    s, s_ref = got["rnd"].get_state(), want["rnd"].get_state()
    np.testing.assert_array_equal(s[1], s_ref[1])


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """(the reference's conftest pipeline, the port resumed from its
    dumps), windows detached from both: the example's global walkthrough
    has none."""
    workdir = tmp_path_factory.mktemp("piston_example")
    ref = build_piston_hrom(workdir)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(workdir)
        mp.setattr(jnp.linalg, "svd", _numpy_svd)
        ref.dump_mu_space()
        ref.dump_reduced_basis()
        port = HyperReducedPiston(**port_setup())
        port.setup()
        port.setup_hyperreduction()
        port.start_from_existing_basis()
        port.project_reductors()
    ref.rom.windows = port.rom.windows = None
    return ref, port


def test_piston_serving_and_certification_match_jax(resumed):
    """examples/piston_rom.py:106-130 on the conftest pipeline: the
    port's ``serve`` (``solve_batch(mode="probes")`` on the example's
    Mach-stratified draw of 32 bins, 28 of them occupied; float32: the
    global lanes engine, 28 lanes being outside the global kernels'
    128-lane gate in both packages) within 3e-5·scale of the JAX
    package's ``solve_batch(mode="probes")`` (float64 under its x64
    default; tests/test_rom.py:196-200's limit), then the port's
    ``certify`` (``estimate_batch``, float64) on 2 of those μ by
    tests/test_hrom.py:442-520's three-part contract against the serial
    path (``rom.solve``, ``srom.solve``), within one package as that
    test holds the JAX package.""" 
    ref, port = resumed
    mus = piston_rom.serving_mus(port.rom)
    mus_ref = [{k: float(v) for k, v in m.items() if k != "piston_mach"}
               for m in ref.rom.build_sampling_space(
                   num=32, rnd=np.random.RandomState(5))]
    assert mus == mus_ref
    served, seconds = piston_rom.serve(port.rom, mus)
    want = ref.rom.solve_batch([dict(m) for m in mus], step=RefStage.ONLINE,
                               mode="probes")
    probes, probes_ref = served["probes"], np.asarray(want["probes"])
    assert probes.shape == probes_ref.shape == (len(mus), 96, 2)
    assert seconds > 0 and np.isfinite(probes).all()
    scale = np.abs(probes_ref).max()
    np.testing.assert_allclose(probes, probes_ref, rtol=0, atol=3e-5 * scale)

    sub = mus[:2]
    est = piston_rom.certify(port, sub)
    assert est[Errors.AVERAGE_ESTIMATOR].shape == (len(sub),)
    V_srom = np.asarray(port.srom.basis)
    serial = {"rom": {"uN": []}, "srom": {"uN": []}}
    with compute_dtype_scope(torch.float64):
        for mu in sub:
            for key, rom in (("rom", port.rom), ("srom", port.srom)):
                rom.solve(dict(mu), Stage.VALIDATION)
                serial[key]["uN"].append(np.asarray(rom.solutions.rom).T)
    serial[RefErrors.ESTIMATOR] = np.array([[compute_rom_difference(
        u, us, V_srom) for u, us in zip(uN, uNs)] for uN, uNs in zip(
        serial["rom"]["uN"], serial["srom"]["uN"])])
    _contract(_host(est), serial, V_srom, limit=3e-8)


def test_generate_goldens_matches_pinned_table():
    """scripts/generate_goldens.py: the port's 20-μ online error table of
    the fixed heat HROM (tests/test_hrom.py ``_heat_config``) against the
    JAX package's pinned tests/goldens/heat_hrom_online_stats.json at
    0.1%, as tests/test_hrom.py:629-680 holds the JAX package."""
    golden_path = REPO / "tests" / "goldens" / "heat_hrom_online_stats.json"
    with open(golden_path) as fh:
        golden = json.load(fh)
    table = generate_goldens.online_stats(device="cpu")
    assert set(table) == set(golden) and len(table) == 20
    for idx, want in golden.items():
        for stat, value in want.items():
            np.testing.assert_allclose(table[idx][stat], value, rtol=1e-3,
                                       err_msg=f"mu {idx} stat {stat}")


def test_graft_entry_forward_matches_jax():
    """__graft_entry__.py:46 ``entry()``: the port's forward (the scanned
    BDF-2 solve of the tiny piston, nx=64, nt=8) on the CPU within 1e-12
    relative of the JAX forward, the same μ."""
    sys.path.insert(0, str(REPO))
    try:
        import __graft_entry__ as graft
    finally:
        sys.path.remove(str(REPO))
    fwd_ref, (mu_ref,) = graft.entry()
    fwd, (mu,) = dryrun.entry(device="cpu")
    assert {k: float(v) for k, v in mu.items()} == {
        k: float(v) for k, v in mu_ref.items()}
    want = np.asarray(fwd_ref(mu_ref))
    with compute_dtype_scope(torch.float64):
        got = fwd(mu)
    assert got.dtype == torch.float64 and got.shape == want.shape == (8, 65)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


#: Every module this slice adds: (module, an argument vector its main
#: parses without a card).
ENTRY_POINTS = (
    ("romtime_tpu_torch.examples.poisson_tutorial", []),
    ("romtime_tpu_torch.examples.heat_2d", []),
    ("romtime_tpu_torch.examples.piston_rom", ["--windowed"]),
    ("romtime_tpu_torch.scripts.mpf1_convergence", ["--nts", "10"]),
    ("romtime_tpu_torch.scripts.permu_diag", []),
    ("romtime_tpu_torch.scripts.corner_attrib", []),
    ("romtime_tpu_torch.scripts.multimu_diag", ["dir", "2"]),
    ("romtime_tpu_torch.scripts.window_study", ["--floor-only"]),
    ("romtime_tpu_torch.scripts.kernel_ledger", ["64", "1"]),
    ("romtime_tpu_torch.scripts.generate_goldens", ["--out", "x.json"]),
)

_BLOCKED_IMPORTS = """
import importlib, sys
for name in ("jax", "romtime_tpu", "pandas"):
    sys.modules[name] = None
import torch
torch.cuda.is_available = lambda: False
from romtime_tpu_torch.parallel import dryrun
for name, argv in {entry_points!r}:
    mod = importlib.import_module(name)
    try:
        mod.main(argv)
    except RuntimeError as exc:
        assert "no CUDA device" in str(exc), (name, exc)
    else:
        raise AssertionError(name + " ran without a card")
try:
    dryrun.entry()
except RuntimeError as exc:
    assert "no CUDA device" in str(exc)
else:
    raise AssertionError("entry() ran without a card")
assert not any(m == "jax" or m.startswith(("jax.", "romtime_tpu."))
               or m == "pandas" for m in sys.modules if sys.modules[m])
print("ok")
"""


def test_new_modules_import_without_jax_and_raise_without_a_card(tmp_path):
    """Each of the slice's modules imports with ``jax``, ``romtime_tpu``
    and ``pandas`` blocked from ``sys.modules`` (in a fresh interpreter),
    and each entry point (every script's ``main`` and ``entry()``)
    raises without a card before it does any work unless given
    ``--device cpu``."""
    code = _BLOCKED_IMPORTS.format(entry_points=ENTRY_POINTS)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
                              "HOME": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
