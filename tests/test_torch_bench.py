"""The port's bench entry (``romtime_tpu_torch/bench.py``, ``python -m
romtime_tpu_torch.bench``) on the CPU (``BENCH_DEVICE=cpu``).

- (a) Against the JAX repository's ``bench.py``: ``bench.main()`` called
  in-process (its POD's SVD routed through numpy, as
  tests/torch_parity.py builds) and the port's :func:`run`, each in its
  own working directory, both on the throughput profile at the
  tests/conftest.py piston size (nx=150, nt=96; bench.py's tf=1), 64
  timed μ (the lanes engine in both: not a whole 128-lane block), no
  ledger. The same payload keys and nesting (the port adds
  ``extra.device``), the same ``rom_modes``, ``batch``, ``nx``, ``nt``,
  ``profile`` and ``engine``; ``rel_l2_vs_fom`` within 1e-9 and the
  float32 drift within 5e-6, tests/test_torch_fleet_certification.py's
  limits (the two packages' float64 trajectories agree to 1e-9·scale,
  tests/test_torch_offline_build.py; the float32 serving limit of
  tests/test_windowed.py:91-94).
- (b) The joint profile at a tiny fleet through the knobs (nx=100,
  nt=60, 3 offline μ, six cells 4x6 ×4 and 2x10 ×2, 3 training μ a cell,
  cell 5 registered): the registered cells, the fleet's shapes, the
  active cell's shape, bench.py's certification keys and a finite probe
  error.
- (c) Without a card the entry raises, in-process and as a module,
  unless ``BENCH_DEVICE=cpu`` asks for the host.
- (d) The warm resume of (b)'s directory serves (b)'s timed batch bit for
  bit.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romtime_tpu_torch import bench as pb
from romtime_tpu_torch.conventions import Stage
from romtime_tpu_torch.problems import JOINT_CENTER_MU
from torch_parity import _numpy_svd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THROUGHPUT = {"BENCH_PROFILE": "throughput", "BENCH_NX": "150",
              "BENCH_NT": "96", "BENCH_ONLINE_MU": "64", "BENCH_LEDGER": "0"}
JOINT = {"BENCH_NX": "100", "BENCH_NT": "60", "BENCH_OFFLINE_MU": "3",
         "BENCH_SROM_MODES": "20", "BENCH_SROM_TRUNCATE": "4",
         "BENCH_NMDEIM": "10", "BENCH_WINDOWS": "4", "BENCH_WINDOW_N": "6",
         "BENCH_CELL_WN": "4x6,4x6,4x6,4x6,2x10,2x10",
         "BENCH_PER_CELL": "3,3,3,3,3,3", "BENCH_REGISTER": "5",
         "BENCH_WINDOW_SROM_EXTRA": "4", "BENCH_ONLINE_MU": "64",
         "BENCH_LEDGER": "0", "BENCH_REPEAT": "2"}
REL_ATOL = 1e-9
F32_REL = 5e-6
#: bench.py's nested keys (bench.py:576-591, :655-661, :695-701, :866-870).
MULTI_KEYS = {"n", "mean", "max", "n_registered", "dil_max",
              "n_dil_flagged", "std"}
STD_KEYS = {"n", "mean", "max", "fom_dt_gap_mean", "fom_dt_gap_max"}
ESTIMATOR_KEYS = {"avg_estimator_mean", "ratio_min", "ratio_max"}
FETCH_KEYS = {"probe_reduce", "wall_s", "solves_per_sec"}


@pytest.fixture(scope="module")
def throughput(tmp_path_factory):
    """(the JAX bench.py's payload, the port's) on the throughput
    profile, each in its own working directory."""
    ref_dir = tmp_path_factory.mktemp("bench_ref")
    port_dir = tmp_path_factory.mktemp("bench_port")
    cache = os.environ.get("ROMTIME_TEST_CACHE",
                           os.path.join(REPO, ".jax_cache"))
    min_secs = jax.config.jax_persistent_cache_min_compile_time_secs
    import bench

    with pytest.MonkeyPatch.context() as mp:
        for k, v in dict(THROUGHPUT, BENCH_CACHE=cache,
                         BENCH_QUIET="1").items():
            mp.setenv(k, v)
        mp.setattr(jnp.linalg, "svd", _numpy_svd)
        mp.chdir(ref_dir)
        capture = _Capture()
        mp.setattr(sys, "stdout", capture)
        try:
            bench.main()
        finally:
            jax.config.update("jax_persistent_cache_min_compile_time_secs",
                              min_secs)
        ref = json.loads(capture.lines()[-1])
        mp.chdir(port_dir)
        port = pb.run(env=THROUGHPUT, device="cpu")
    return ref, port


class _Capture:
    """A stdout that keeps what is written."""

    def __init__(self):
        self.parts = []

    def write(self, s):
        self.parts.append(s)

    def flush(self):
        pass

    def lines(self):
        return [ln for ln in "".join(self.parts).splitlines() if ln.strip()]


def test_throughput_keys_against_bench_py(throughput):
    """The same keys and nesting as bench.py's line, ``extra.device``
    added; the package's key lists are bench.py's."""
    ref, port = throughput
    assert tuple(ref) == pb.PAYLOAD_KEYS == tuple(port)
    assert set(port["extra"]) == set(ref["extra"]) | {"device"}
    assert tuple(ref["extra"]) + ("device",) == pb.EXTRA_KEYS
    for k, v in ref["extra"].items():
        got = port["extra"][k]
        assert (got is None) == (v is None), k
        if isinstance(v, dict):
            assert set(got) == set(v), k
    assert set(port["extra"]["fetch_inclusive"]) == FETCH_KEYS
    assert port["extra"]["device"] == "cpu"
    assert port["extra"]["backend"] == ref["extra"]["backend"] == "cpu"


def test_throughput_numbers_against_bench_py(throughput):
    """The configuration as bench.py reports it, the center μ's float64
    rel-L2 within 1e-9 and the float32 drift within 5e-6 of bench.py's."""
    ref, port = throughput
    for k in ("profile", "rom_modes", "batch", "nx", "nt", "mode", "engine",
              "n_windows", "window_n", "offline_build", "solve_iters"):
        assert port["extra"][k] == ref["extra"][k], k
    assert (port["extra"]["rom_modes"], port["extra"]["engine"]) == (
        15, "lanes")
    assert port["metric"] == ref["metric"] and port["unit"] == ref["unit"]
    assert abs(port["rel_l2_vs_fom"] - ref["rel_l2_vs_fom"]) <= REL_ATOL
    assert port["extra"]["rel_l2_vs_fom"] == port["rel_l2_vs_fom"]
    assert abs(port["extra"]["f32_serving_drift"]
               - ref["extra"]["f32_serving_drift"]) <= F32_REL
    assert 0 < port["extra"]["f32_serving_drift"] < 1e-4
    assert port["value"] > 0 and port["vs_baseline"] == round(
        port["value"] / pb.BASELINE_SOLVES_PER_SEC, 4)


@pytest.fixture(scope="module")
def joint(tmp_path_factory):
    """The joint profile at a tiny fleet, built cold in its directory:
    (workdir, hrom, measure's result)."""
    workdir = tmp_path_factory.mktemp("bench_joint")
    cfg = pb.settings(JOINT)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(workdir)
        mp.setenv("BENCH_QUIET", "1")
        hrom, info = pb.build(cfg, torch.device("cpu"))
        res = pb.measure(hrom, cfg, info, cache_dir=".")
    assert not info["warm"]
    return workdir, hrom, res


def test_joint_tiny_fleet(joint):
    """The fleet the knobs ask for, the active cell's shape, bench.py's
    certification keys, a finite probe error and the FOM caches."""
    workdir, hrom, res = joint
    p = res["payload"]
    extra = p["extra"]
    assert tuple(p) == pb.PAYLOAD_KEYS and tuple(extra) == pb.EXTRA_KEYS
    assert extra["profile"] == "joint"
    assert extra["registered_cells"] == [5]
    assert extra["cell_wn"] == [[4, 6]] * 4 + [[2, 10]] * 2
    ml = hrom.rom.mulocal
    active = int(ml.cell_of(hrom.rom.compute_piston_mach_number(
        JOINT_CENTER_MU)))
    assert [extra["n_windows"], extra["window_n"]] == extra["cell_wn"][active]
    assert hrom.rom.windows is ml.cells[active]
    assert extra["engine"] == "windowed-pallas" and extra["batch"] == 64
    assert extra["kernel_ledger"] is None
    assert np.isfinite(extra["served_engine_probe_err"])
    assert 0 < extra["served_engine_probe_err"] < 1e-3
    multi = extra["rel_l2_multi_mu"]
    assert set(multi) == MULTI_KEYS and multi["n"] == 15
    assert set(multi["std"]) == STD_KEYS == set(extra["rel_l2_multi_mu_std"])
    assert multi["n_registered"] >= 1
    assert set(extra["windowed_estimator"]) == ESTIMATOR_KEYS
    assert np.isfinite(p["rel_l2_vs_fom"]) and p["rel_l2_vs_fom"] < 1e-2
    assert extra["f32_serving_drift"] < pb.F32_DRIFT_MAX
    assert res["fleet"]["n_cells"] == 6
    for name in (pb.FOM_CACHE, pb.FOM_CACHE_MULTI, pb.FOM_CACHE_STD):
        assert (workdir / name).exists(), name
    json.dumps(p)


def test_entry_needs_the_card(tmp_path):
    """Without CUDA the entry raises before it touches a directory, in
    process and as ``python -m romtime_tpu_torch.bench``, unless
    ``BENCH_DEVICE=cpu``."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pb.run(env={})
    with pytest.raises(RuntimeError, match="BENCH_DEVICE=cpu"):
        pb.run(env={"BENCH_DEVICE": "cuda"})
    env = {k: v for k, v in os.environ.items() if k != "BENCH_DEVICE"}
    env.update(CUDA_VISIBLE_DEVICES="", BENCH_DIR=str(tmp_path / "dir"))
    proc = subprocess.run([sys.executable, "-m", "romtime_tpu_torch.bench"],
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert proc.stdout.strip() == ""
    assert not (tmp_path / "dir").exists()


def test_warm_resume_serves_bit_for_bit(joint):
    """A second entry in (b)'s directory resumes warm (no build) and
    serves (b)'s timed batch bit for bit."""
    workdir, _hrom, res = joint
    cfg = pb.settings(JOINT)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(workdir)
        mp.setenv("BENCH_QUIET", "1")
        warm, info = pb.build(cfg, torch.device("cpu"))
    assert info["warm"]
    assert warm.rom.mulocal.cell_wn == [(4, 6)] * 4 + [(2, 10)] * 2
    out = warm.rom.solve_batch(res["mus"], step=Stage.ONLINE, mode="probes",
                               host=False)
    for k in ("probes", "uN_final"):
        np.testing.assert_array_equal(out[k].numpy(), res["outs"][k])
