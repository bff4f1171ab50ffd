"""The port's legacy MFP1 drivers (romtime_tpu_torch/problems/
mfp1_legacy.py) and the heat family's windowed serving against the JAX
package, both built by each package once per module (nx=60, nt=40):
tests/test_mfp1_legacy.py (without the plots) and
tests/test_windowed.py:236-300.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from romtime_tpu.conventions import Stage as RefStage
from romtime_tpu.dtypes import compute_dtype_scope as ref_dtype_scope
from romtime_tpu_torch.conventions import Stage
from romtime_tpu_torch.dtypes import compute_dtype_scope
from test_torch_heat_hrom import F64, build, port_config, ref_build
from torch_parity import _numpy_svd

jax.config.update("jax_enable_x64", True)


# ---------------------------------------------------------------------------
# The legacy drivers and the windowed heat serving (nx=60, nt=40)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def legacy_pair(tmp_path_factory):
    """tests/test_mfp1_legacy.py:22-44, built by both packages; the
    port's with its windowed serving (4 windows of N=8,
    tests/test_windowed.py:276), the reference's too."""
    from romtime_tpu_torch.problems.mfp1_legacy import (
        HyperReducedOrderModelFixed as Legacy,
    )

    ref = ref_build(False, tmp_path_factory.mktemp("ref_legacy"), 60, 40,
                    legacy=True)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jnp.linalg, "svd", _numpy_svd)
        ref.build_windowed_serving(n_windows=4, num_basis=8, dump=False)
    port = build(Legacy, port_config(nx=60, nt=40),
                 tmp_path_factory.mktemp("port_legacy"), device="cpu")
    port.build_windowed_serving(n_windows=4, num_basis=8, dump=False)
    return ref, port


def test_legacy_online_with_explicit_mu_space(legacy_pair):
    """tests/test_mfp1_legacy.py:47-60: per-μ error series against the
    manufactured solution, the settled tail under 1e-4; equal to the JAX
    package's (1e-6 relative)."""
    ref, hrom = legacy_pair
    space = hrom.mu_space[Stage.OFFLINE][:2]
    with compute_dtype_scope(F64):
        errors = hrom.evaluate_online(mu_space=space)
    with ref_dtype_scope(jnp.float64):
        want = ref.evaluate_online(mu_space=ref.mu_space[RefStage.OFFLINE][:2])
    assert len(errors) == len(space)
    for idx, series in errors.items():
        series = np.asarray(series)
        assert series.ndim == 1 and series.size > 0
        assert float(series[-1]) < 1e-4
        w = np.asarray(want[idx])
        assert np.abs(series - w).max() <= 1e-6 * np.abs(w).max()


def test_legacy_online_with_params(legacy_pair):
    """tests/test_mfp1_legacy.py:63-69; summaries (:72-76, the plots
    wait for the plotting auxiliaries)."""
    _ref, hrom = legacy_pair
    with compute_dtype_scope(F64):
        errors = hrom.evaluate_online(params={"num": 2},
                                      rnd=np.random.RandomState(1))
    assert len(errors) >= 2
    with pytest.raises(ValueError):
        hrom.evaluate_online()
    hrom.generate_summary()
    assert hrom.summary_basis["index"] and hrom.summary_errors["index"]


def test_legacy_moving_driver_smoke(tmp_path):
    """tests/test_mfp1_legacy.py:86-111."""
    from romtime_tpu_torch.problems.mfp1_legacy import (
        HyperReducedOrderModelMoving as Legacy,
    )

    grid, fp, rp, dp, mp, models = port_config(nx=40, nt=30, moving=True)
    with pytest.MonkeyPatch.context() as m:
        m.chdir(tmp_path)
        hrom = Legacy(grid=grid, fom_params=fp, rom_params=rp,
                      deim_params=dp, mdeim_params=mp, models=models,
                      rnd=np.random.RandomState(0), device="cpu")
        hrom.setup()
        hrom.setup_hyperreduction()
        assert not hrom.deim_moving_runned
        hrom.run_offline_rom()
        hrom.run_offline_hyperreduction(
            mu_space=hrom.mu_space[Stage.OFFLINE], evaluate=False)
        assert hrom.deim_moving_runned
        hrom.project_reductors()
    with compute_dtype_scope(F64):
        errors = hrom.evaluate_online(
            mu_space=hrom.mu_space[Stage.OFFLINE][:1])
    series = np.asarray(next(iter(errors.values())))
    assert series.size > 0 and float(series[-1]) < 1e-2


def test_legacy_define_mfp1_reexport():
    """tests/test_mfp1_legacy.py:114-116, and the old import path."""
    from romtime_tpu_torch.problems import mfp1, mfp1_legacy

    assert len(mfp1_legacy.define_mfp1_problem(2.0, 20, 1.0, 10)) == 7
    assert mfp1.HyperReducedOrderModelFixed is (
        mfp1_legacy.HyperReducedOrderModelFixed)


def test_windowed_heat(legacy_pair):
    """tests/test_windowed.py:236-300: the heat ROM's windows (no
    trilinear table) serve ``mode="full"`` through the float64 windowed
    lanes engine within 1e-4 of the FOM."""
    _ref, hrom = legacy_pair
    rom = hrom.rom
    assert rom.windows.trilinear is None
    mu_val = dict(delta=0.9, beta=4.5, alpha_0=1.1)
    fom = hrom.fom
    fom.setup()
    fom.update_parametrization(mu_val)
    with compute_dtype_scope(F64):
        fom.solve()
        outs = rom.solve_batch([dict(mu_val)], step=Stage.VALIDATION,
                               mode="full", engine="windowed")
    uh_fom = np.asarray(fom.solutions.fom)
    u = outs["uc"][0].T
    assert np.linalg.norm(u - uh_fom) / np.linalg.norm(uh_fom) < 1e-4


@pytest.mark.parametrize("branch", ["matrices", "fused", "v2"])
def test_windowed_heat_served(legacy_pair, branch, monkeypatch):
    """The heat windows served in float32 on each stage-2 branch (K2's,
    K1's and K3's twins, ``with_trilinear=False``, BDF-1) within
    5e-6·scale of the float32 windowed lanes engine (``uN_final`` 5e-5,
    tests/test_windowed.py:91-94), and of the JAX package's served
    windows on its own build carried across (5e-6·scale)."""
    from romtime_tpu_torch import serving_from_arrays
    from torch_parity import heat_payload_from_rom, reference_solve

    ref, hrom = legacy_pair
    rom = hrom.rom
    mus = [dict(m) for m in rom.build_sampling_space(
        num=16, rnd=np.random.RandomState(11))]
    lanes = rom.solve_batch(mus, mode="probes", engine="windowed")
    if branch != "matrices":
        monkeypatch.setattr(type(rom), "ONLINE_PRECOMPUTE_BUDGET", 0)
        monkeypatch.setenv("ROMTIME_WINDOWED_KERNEL", branch)
    served = rom.solve_batch(mus, mode="probes")
    scale = max(np.abs(lanes["probes"]).max(), 1e-3)
    assert np.abs(served["probes"] - lanes["probes"]).max() <= 5e-6 * scale
    assert np.abs(served["uN_final"] - lanes["uN_final"]).max() <= 5e-5

    # The reference's kernels take whole 128-lane blocks.
    mus = (mus * 8)[:128]
    port_ref = serving_from_arrays(heat_payload_from_rom(ref.rom,
                                                         windows=True),
                                   device="cpu")
    got = port_ref.solve_batch(mus, mode="probes")
    want = reference_solve(ref.rom, mus, branch=branch)
    assert np.abs(got["probes"] - want["probes"]).max() <= 5e-6 * scale
    assert np.abs(got["uN_final"] - want["uN_final"]).max() <= 5e-5
