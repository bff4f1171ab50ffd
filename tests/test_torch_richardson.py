"""K1's Richardson solve in the port against the JAX reference.

- ``lanes_invert``/``richardson_solve`` against ``_lanes_invert`` and
  ``_richardson_solve`` at the shapes of
  tests/test_pallas_online.py::test_lanes_invert_and_richardson (:560):
  inverse atol 5e-5, solve atol 2e-6·max|exact|, cold and warm, padded
  rows exactly 0;
- the K1 twin with ``solve_iters`` ∈ {3, 6} against the interpreted
  reference kernel on the damped synthetic tables of
  test_windowed_fused_ablate_variants_run (:608-665), at N=12 and N=24:
  atol 2e-5·scale for probes and state (the fused kernel tests' limit);
- served Richardson on the conftest piston cell (W=4 windows of N=12,
  nt=96), reference against port, probes 5e-6·scale and ``uN_final`` 5e-5
  (tests/test_windowed.py:121-125): forced by ROMTIME_SOLVE_ITERS=6, and
  picked by the auto policy itself.

The CUDA kernel is held against the twin on the card
(tests/test_torch_cuda.py, marked ``cuda``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romtime_tpu.ops.pallas_online import (
    _lanes_invert,
    _richardson_solve,
    online_sweep_windowed_fused as ref_sweep,
)
from romtime_tpu_torch import serving_from_arrays
from romtime_tpu_torch.ops import windowed_fused as k1
from test_torch_windowed_fused import _tables
from torch_parity import (
    assert_served_close,
    build_piston_hrom,
    clear_serving_caches,
    payload_from_rom,
    piston_mus,
    port_branch,
    reference_solve,
)


def _invert_case():
    """The K and K_t of test_lanes_invert_and_richardson (seed 3)."""
    rng = np.random.default_rng(3)
    NP, BL, N = 16, 128, 12
    K = np.zeros((NP, NP, BL), np.float32)
    K[np.arange(NP), np.arange(NP)] = 1.0
    K[:N, :N] += 0.15 * rng.normal(size=(N, N, BL)).astype(np.float32)
    Kt = K.copy()
    Kt[:N, :N] += 0.01 * rng.normal(size=(N, N, BL)).astype(np.float32)
    r = rng.normal(size=(NP, BL)).astype(np.float32)
    r[N:] = 0.0
    return NP, N, K, Kt, r


def test_lanes_invert_matches_reference():
    NP, N, K, _Kt, _r = _invert_case()
    want = np.asarray(_lanes_invert(jnp.asarray(K), NP))
    got = k1.lanes_invert(torch.from_numpy(K), NP).numpy()
    for b in (0, 17, K.shape[2] - 1):
        np.testing.assert_allclose(got[:, :, b] @ K[:, :, b], np.eye(NP),
                                   atol=5e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)
    # The padded block inverts to the identity, exactly.
    np.testing.assert_array_equal(got[N:, N:], want[N:, N:])
    assert np.all(got[N:, :N] == 0.0) and np.all(got[:N, N:] == 0.0)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_richardson_solve_matches_reference(warm):
    NP, N, K, Kt, r = _invert_case()
    Kinv = np.array(_lanes_invert(jnp.asarray(K), NP))
    exact = np.stack([np.linalg.solve(Kt[:, :, b], r[:, b])
                      for b in range(K.shape[2])], axis=1)
    delta0 = (exact * 0.99).astype(np.float32) if warm else None
    want = np.asarray(_richardson_solve(
        jnp.asarray(Kt), jnp.asarray(Kinv), jnp.asarray(r), 8,
        delta0=None if delta0 is None else jnp.asarray(delta0)))
    got = k1.richardson_solve(
        torch.from_numpy(Kt), torch.from_numpy(Kinv), torch.from_numpy(r), 8,
        delta0=None if delta0 is None else torch.from_numpy(delta0)).numpy()
    tol = 2e-6 * np.abs(exact).max()
    np.testing.assert_allclose(got, exact, rtol=0, atol=tol)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert np.all(got[N:] == 0.0)


@pytest.mark.parametrize("iters", [3, 6])
@pytest.mark.parametrize("N", [12, 24])
def test_twin_richardson_matches_reference_kernel(N, iters):
    """Damped within-window θ (m + 0.05·(θ − m), as :623-625 damps it)
    keeps the window-mean preconditioner's contraction strong."""
    args, kw = _tables(N, seed=N, smooth=True)
    ref_p, ref_s = ref_sweep(*[jnp.asarray(a) for a in args], **kw,
                             interpret=True, solve_iters=iters,
                             paired_lu=5)
    ref_p, ref_s = np.asarray(ref_p), np.asarray(ref_s)
    assert np.isfinite(ref_p).all() and np.isfinite(ref_s).all()
    launches = k1.online_sweep_windowed_fused.launches
    got_p, got_s = k1.online_sweep_windowed_fused(
        *[torch.from_numpy(a) for a in args], **kw, solve_iters=iters,
        paired_lu=5)
    assert k1.online_sweep_windowed_fused.launches == launches
    got_p, got_s = got_p.numpy(), got_s.numpy()
    scale = np.abs(ref_p).max()
    np.testing.assert_allclose(got_p, ref_p, rtol=0, atol=2e-5 * scale)
    sscale = np.abs(ref_s[[0, 2]]).max()
    np.testing.assert_allclose(got_s[[0, 2]], ref_s[[0, 2]], rtol=0,
                               atol=2e-5 * sscale)


def test_window_mean_theta_matches_reference_layout():
    """THbar: per-window mean of the θm/θk rows, 1.5 on the mass rows
    (pallas_online.py:1681-1690); 1.0 under BDF-1."""
    args, kw = _tables(12, seed=1)
    TH = args[0]
    W, width = len(kw["widths"]), kw["widths"][0]
    km8, kk8 = kw["km8"], kw["kk8"]
    mean = TH.reshape(W, width, TH.shape[1], -1)[:, :, :km8 + kk8].mean(1)
    for bdf2, bdf in ((True, 1.5), (False, 1.0)):
        got = k1.window_mean_theta(torch.from_numpy(TH), W, km8, kk8,
                                   bdf2).numpy()
        want = mean.copy()
        want[:, :km8] *= bdf
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_wrapper_rejects_zero_iterations():
    args, kw = _tables(12, seed=2)
    with pytest.raises(ValueError, match="solve_iters"):
        k1.online_sweep_windowed_fused(
            *[torch.from_numpy(a) for a in args], **kw, solve_iters=0)


@pytest.fixture(scope="module")
def piston_cell(tmp_path_factory):
    """The conftest windowed piston pipeline (torch_parity)."""
    rom = build_piston_hrom(tmp_path_factory.mktemp("torch_richardson")).rom
    return rom, payload_from_rom(rom)


def _spy_solve_iters(monkeypatch):
    """Record the solve_iters each K1 call of the port's engine gets."""
    from romtime_tpu_torch.rom.engines import windowed_fused as engine

    seen = []
    real = engine.online_sweep_windowed_fused

    def spy(*args, **kw):
        seen.append(kw.get("solve_iters"))
        return real(*args, **kw)

    monkeypatch.setattr(engine, "online_sweep_windowed_fused", spy)
    return seen


def test_served_forced_richardson_matches_reference(piston_cell, monkeypatch):
    """ROMTIME_SOLVE_ITERS=6 on both sides, fused branch (precompute
    budget 0): Richardson inside K1 although this cell's ρ would not
    admit it."""
    rom, payload = piston_cell
    mus = piston_mus(128, seed=20)
    monkeypatch.setenv("ROMTIME_SOLVE_ITERS", "6")
    port = port_branch(serving_from_arrays(payload, device="cpu"), "fused",
                       monkeypatch)
    seen = _spy_solve_iters(monkeypatch)
    got = port.solve_batch(mus, mode="probes")
    assert seen == [6]
    ref = reference_solve(rom, mus, branch="fused", solve_iters="6")
    assert_served_close(got, ref)


def test_served_auto_richardson_matches_reference(piston_cell, monkeypatch):
    """The auto policy picks Richardson on both sides: each class's
    ``_auto_iters_rho`` returns ρ = 0.005 (ρ_eff = 0.0265 → 5 iterations,
    at the perf cap). Raising the caps would not do: this cell measures
    ρ = 0.1744 on both sides (ρ_eff 0.247 → 13 iterations, past the
    accuracy cap of 12, so it serves the LU)."""
    from romtime_tpu.rom.rom import RomConstructorNonlinear as Ref
    from romtime_tpu_torch.rom.rom import RomConstructorNonlinear as Port

    rom, payload = piston_cell
    mus = piston_mus(128, seed=21)
    monkeypatch.delenv("ROMTIME_SOLVE_ITERS", raising=False)
    for cls in (Ref, Port):
        monkeypatch.setattr(cls, "_auto_iters_rho",
                            lambda self, *a, **k: 0.005)
    port = port_branch(serving_from_arrays(payload, device="cpu"), "fused",
                       monkeypatch)
    seen = _spy_solve_iters(monkeypatch)
    rom.windows.__dict__.pop("_auto_iters_memo", None)
    try:
        got = port.solve_batch(mus, mode="probes")
        ref = reference_solve(rom, mus, branch="fused", solve_iters=None)
        assert rom._auto_iters_for(rom.windows) == 5
    finally:
        rom.windows.__dict__.pop("_auto_iters_memo", None)
        clear_serving_caches(rom)
    assert seen == [5]
    assert_served_close(got, ref)
