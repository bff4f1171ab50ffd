"""The port's windowed lanes engine (``engine="windowed"``,
romtime_tpu_torch/rom/engines/windowed_lanes.py) and its batch-last
Gauss-Jordan (romtime_tpu_torch/ops/linalg.py) against the JAX package,
and the port's served engine against the port's lanes engine, on the
conftest windowed piston cell (nx=150, nt=96, W=4 windows of N=12) built
by the JAX package (tests/torch_parity.build_piston_hrom).

Limits: the lanes engines agree at 1e-9·scale in float64 and 5e-6·scale
in float32 (the dd carry), per output; the served engine meets the lanes
engine at tests/test_windowed.py:77-125's limits (probes 5e-6·scale,
uN_final 5e-5) on every stage-2 branch. F6: ``solve_batch`` takes the
reference's ``host`` argument in the reference's position."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romtime_tpu.conventions import Stage
from romtime_tpu.dtypes import compute_dtype_scope
from romtime_tpu.ops.linalg import gauss_solve_lanes as ref_gauss_solve_lanes
from romtime_tpu.rom.rom import RomConstructorNonlinear as RefRCN
from romtime_tpu_torch import (
    DilationLaw,
    RomConstructorNonlinear,
    serving_from_arrays,
)
from romtime_tpu_torch.dtypes import compute_dtype_scope as port_dtype_scope
from romtime_tpu_torch.ops.linalg import gauss_solve_lanes
from test_torch_serving import LAW_PAYLOAD
from torch_parity import (
    BRANCHES,
    build_piston_hrom,
    clear_serving_caches,
    payload_from_rom,
    piston_mus,
    port_branch,
)

DTYPES = {"float64": (jnp.float64, torch.float64, 1e-9),
          "float32": (jnp.float32, torch.float32, 5e-6)}


@pytest.fixture(scope="module")
def piston_cell(tmp_path_factory):
    rom = build_piston_hrom(tmp_path_factory.mktemp("torch_lanes")).rom
    return rom, payload_from_rom(rom)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("shared", [False, True])
def test_gauss_solve_lanes_matches_reference(dtype, shared):
    rng = np.random.default_rng(3)
    N, B = 12, 7
    A = rng.normal(size=(N, N) if shared else (N, N, B)) * 0.1
    A[np.arange(N), np.arange(N)] += 2.0
    b = rng.normal(size=(N, B))
    jdt, tdt, _tol = DTYPES[dtype]
    want = np.asarray(ref_gauss_solve_lanes(jnp.asarray(A, jdt),
                                            jnp.asarray(b, jdt)))
    got = gauss_solve_lanes(torch.as_tensor(A, dtype=tdt),
                            torch.as_tensor(b, dtype=tdt)).numpy()
    rtol = 1e-13 if dtype == "float64" else 2e-6
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())
    Ab = A if not shared else np.broadcast_to(A[:, :, None], (N, N, B))
    resid = np.einsum("ijB,jB->iB", Ab, got) - b
    assert np.abs(resid).max() < (1e-12 if dtype == "float64" else 1e-5)


def _ref_lanes(rom, mus, mode, jdt):
    with compute_dtype_scope(jdt):
        clear_serving_caches(rom)
        try:
            return rom.solve_batch(mus, step=Stage.ONLINE, mode=mode,
                                   engine="windowed")
        finally:
            clear_serving_caches(rom)


def _assert_outputs_close(got, want, rel):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, (k, g.shape, w.shape)
        assert np.isfinite(g).all(), k
        scale = max(np.abs(w).max(), 1e-3)
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * scale,
                                   err_msg=k)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("mode", ["probes", "reduced", "full"])
def test_lanes_engine_matches_reference(piston_cell, mode, dtype):
    """engine="windowed" in every mode against the JAX package's lanes
    engine on the same μ (f64: plain carry; f32: the dd carry)."""
    rom, payload = piston_cell
    jdt, tdt, rel = DTYPES[dtype]
    mus = piston_mus(4, seed=5)
    want = _ref_lanes(rom, mus, mode, jdt)
    port = serving_from_arrays(payload, device="cpu")
    with port_dtype_scope(tdt):
        got = port.solve_batch(mus, step=Stage.ONLINE, mode=mode,
                               engine="windowed")
    assert all(v.dtype == np.dtype(dtype) for k, v in got.items()), got
    _assert_outputs_close(got, want, rel)


@pytest.mark.parametrize("branch", BRANCHES)
def test_served_matches_lanes(piston_cell, monkeypatch, branch):
    """tests/test_windowed.py:77-125 on the port: the served f32 engine on
    each stage-2 branch (materialized K2, fused K1, v2 K3) against the
    port's f32 lanes engine on 128 μ."""
    _rom, payload = piston_cell
    mus = piston_mus(128, seed=6)
    port = port_branch(serving_from_arrays(payload, device="cpu"), branch,
                       monkeypatch)
    lanes = port.solve_batch(mus, mode="probes", engine="windowed")
    served = port.solve_batch(mus, mode="probes", engine="windowed-pallas")
    scale = max(np.abs(lanes["probes"]).max(), 1e-3)
    np.testing.assert_allclose(served["probes"], lanes["probes"], rtol=0,
                               atol=5e-6 * scale)
    np.testing.assert_allclose(served["uN_final"], lanes["uN_final"],
                               rtol=0, atol=5e-5)


def test_lanes_tables_cached_per_mode_and_dtype(piston_cell, monkeypatch):
    """The lanes tables live on the windows object, one set per (mode,
    compute dtype), and a repeated call reuses them with the same
    result."""
    import romtime_tpu_torch.rom.rom as rom_mod

    _rom, payload = piston_cell
    port = serving_from_arrays(payload, device="cpu")
    built = []
    real = rom_mod.windowed_lanes_tables
    monkeypatch.setattr(rom_mod, "windowed_lanes_tables",
                        lambda *a: built.append(a[2:4]) or real(*a))
    mus = piston_mus(3, seed=7)
    first = port.solve_batch(mus, mode="reduced", engine="windowed")
    again = port.solve_batch(mus, mode="reduced", engine="windowed")
    port.solve_batch(mus, mode="probes", engine="windowed")
    with port_dtype_scope(torch.float64):
        port.solve_batch(mus, mode="probes", engine="windowed")
    assert built == [("reduced", torch.float32), ("probes", torch.float32),
                     ("probes", torch.float64)]
    for k in first:
        np.testing.assert_array_equal(again[k], first[k])


def test_unequal_widths_raise(piston_cell):
    """Unequal widths take the chained variant (reference
    windowed_lanes.py:119-121), which serves; only registered (dilated)
    serving on unequal widths raises, with the reference's reason
    (:309-314)."""
    _rom, payload = piston_cell
    port = serving_from_arrays(payload, device="cpu")
    port.windows.bounds = np.array([0, 20, 48, 72, 96])
    out = port.solve_batch(piston_mus(2), mode="probes", engine="windowed")
    assert out["probes"].shape == (2, 96, 2)
    assert np.isfinite(out["probes"]).all()
    port.windows.dilation = DilationLaw.from_payload(**LAW_PAYLOAD)
    with pytest.raises(NotImplementedError, match="equal window widths"):
        port.solve_batch(piston_mus(2), mode="probes", engine="windowed")


@pytest.mark.parametrize("engine,mode", [("windowed-pallas", "probes"),
                                         ("windowed", "probes"),
                                         ("windowed", "full")])
def test_host_false_returns_device_tensors(piston_cell, engine, mode):
    """F6: host=False returns the unmoved (nt, …, B) tensors, equal to
    the host copy once moved batch-first, through the reference's
    positional order (mus, step, mode, engine, host)."""
    _rom, payload = piston_cell
    port = serving_from_arrays(payload, device="cpu")
    mus = piston_mus(5, seed=8)
    host = port.solve_batch(mus, Stage.ONLINE, mode, engine, True)
    dev = port.solve_batch(mus, Stage.ONLINE, mode, engine, False)
    assert set(dev) == set(host)
    for k, v in dev.items():
        assert isinstance(v, torch.Tensor) and v.device == port.device
        if v.ndim >= 2:
            assert v.shape[-1] == 5, (k, v.shape)
        moved = (v.movedim(-1, 0) if v.ndim >= 2 else v).numpy()
        np.testing.assert_array_equal(moved, host[k], err_msg=k)
    reduced = port.solve_batch(mus, Stage.ONLINE, mode, engine, False,
                               "mean")
    if "probes" in reduced:
        assert reduced["probes"].shape == (2, 5)


def test_solve_batch_signature_matches_reference():
    """F6: the parameters, in order and with defaults, are the
    reference's (bench.py passes host=False)."""
    def params(fn):
        return [(p.name, p.default) for p in
                inspect.signature(fn).parameters.values()]

    assert params(RomConstructorNonlinear.solve_batch) == params(
        RefRCN.solve_batch)
    assert params(RomConstructorNonlinear.solve_batch_mulocal) == params(
        RefRCN.solve_batch_mulocal)
