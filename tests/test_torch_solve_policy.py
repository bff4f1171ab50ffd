"""The serving policy and guards of the port against the JAX reference:

- the auto solve policy (romtime_tpu/rom/engines/policy.py:124-274): the
  measured ρ within 1e-9 relative of the reference's ``_auto_iters_rho``
  on the conftest piston cell, the same iteration count or LU, and the
  ``ROMTIME_SOLVE_ITERS`` override (mirrors the policy's use in
  tests/test_windowed.py:779-845, single-cell);
- the pivot-free guard (romtime_tpu/rom/rom.py:858-940): cond₂ within
  1e-4 relative of the reference's ``certify_pivot_free`` on the same
  cell; the ill-conditioned family refused and the benign one passed
  (tests/test_pivot_guard.py:84, :90); ``PIVOT_GUARD="off"`` and a
  missing global basis skip it;
- F1, closed: ``solve_batch``'s default mode is the reference's
  ``"reduced"``, which runs the global lanes engine: a bare call serves
  there, and raises ``ValueError`` without a global configuration;
- F4: the paired-LU period is the reference's kernel chunk
  ``_fused_chunk`` (pallas_online.py:1591-1602), and serving passes it.
"""

import numpy as np
import pytest
import torch

from romtime_tpu.ops.pallas_online import PROBE_P, _fused_chunk
from romtime_tpu_torch import serving_from_arrays
from romtime_tpu_torch.rom.engines.policy import (
    box_corners,
    paired_lu_period,
)
from romtime_tpu_torch.rom.rom import RomConstructorNonlinear
from torch_parity import build_piston_hrom, payload_from_rom, piston_mus


@pytest.fixture(scope="module")
def piston_cell(tmp_path_factory):
    """The conftest windowed piston pipeline (torch_parity), with its
    global basis (N=35) beside the W=4, N=12 windows."""
    rom = build_piston_hrom(tmp_path_factory.mktemp("torch_policy")).rom
    return rom, payload_from_rom(rom)


def _reference_corners(rom):
    """The reference's corner list (policy.py:211-218)."""
    import itertools

    corners = []
    for vals in itertools.product(*[
            (float(min(d.support())), float(max(d.support())))
            for d in rom.grid.values()]):
        mu = dict(zip(rom.grid.keys(), vals))
        if mu not in corners:
            corners.append(mu)
    return corners


def test_auto_rho_and_iters_match_reference(piston_cell, monkeypatch):
    rom, payload = piston_cell
    monkeypatch.delenv("ROMTIME_SOLVE_ITERS", raising=False)
    port = serving_from_arrays(payload, device="cpu")
    win, pwin = rom.windows, port.windows
    sources = rom._theta_sources()
    stiff = [n for n in sources if n not in ("mass", "rhs_vec")]
    corners = _reference_corners(rom)
    assert len(box_corners(port.grid)) == len(corners) == 8
    want = rom._auto_iters_rho(corners[:8], np.asarray(win.bounds), sources,
                               stiff, float(rom.fom.dt), win.n_windows,
                               win.N, win)
    got = port._auto_iters_for(pwin)
    rho = pwin._auto_iters_rho_value
    assert abs(rho - want) <= 1e-9 * want, (rho, want)
    win.__dict__.pop("_auto_iters_memo", None)
    try:
        assert got == rom._auto_iters_for(win)
    finally:
        win.__dict__.pop("_auto_iters_memo", None)
    # ρ = 0.1744 here: ρ_eff 0.247 needs 13 iterations, past both caps.
    assert got is None and port._windowed_solve_iters() is None


@pytest.mark.parametrize("rho,iters", [(0.0, 5), (0.005, 5), (0.01, 6),
                                       (0.03, 7), (0.05, 8), (0.5, None)])
def test_auto_iters_count_and_caps(piston_cell, monkeypatch, rho, iters):
    """ρ → ⌈log 3e-8 / log(min(1.3ρ + 0.02, 0.999))⌉, LU above
    min(WINDOWED_SOLVE_ITERS_CAP, WINDOWED_SOLVE_ITERS_PERF_CAP) = 5; an
    instance that raises its perf cap gets the count up to 12."""
    _rom, payload = piston_cell
    monkeypatch.delenv("ROMTIME_SOLVE_ITERS", raising=False)
    monkeypatch.setattr(RomConstructorNonlinear, "_auto_iters_rho",
                        lambda self, *a, **k: rho)
    port = serving_from_arrays(payload, device="cpu")
    assert port._windowed_solve_iters() == (iters if iters and iters <= 5
                                            else None)
    port = serving_from_arrays(payload, device="cpu")
    port.WINDOWED_SOLVE_ITERS_PERF_CAP = 12
    assert port._windowed_solve_iters() == iters


@pytest.mark.parametrize("env,setting,want", [
    ("4", "auto", 4), ("0", "auto", None), ("0", 7, None), ("", 3, 3),
    (None, 6, 6), (None, None, None)])
def test_solve_iters_override(piston_cell, monkeypatch, env, setting, want):
    """ROMTIME_SOLVE_ITERS wins (0 → LU, n → n); otherwise the instance's
    WINDOWED_SOLVE_ITERS (a count, or None for the LU). The LU is the
    per-step one (group None) unless ROMTIME_PAIRED_LU names a group."""
    _rom, payload = piston_cell
    monkeypatch.delenv("ROMTIME_PAIRED_LU", raising=False)
    if env is None:
        monkeypatch.delenv("ROMTIME_SOLVE_ITERS", raising=False)
    else:
        monkeypatch.setenv("ROMTIME_SOLVE_ITERS", env)
    port = serving_from_arrays(payload, device="cpu")
    port.WINDOWED_SOLVE_ITERS = setting
    assert port._windowed_solve_iters() == want
    iters, group, mode = port.windowed_solve()
    assert iters == want and (group, mode) == (None, "sub1")
    assert RomConstructorNonlinear.WINDOWED_SOLVE_ITERS == "auto"


def test_guard_matches_reference(piston_cell):
    rom, payload = piston_cell
    want = rom.certify_pivot_free()
    port = serving_from_arrays(payload, device="cpu")
    assert port._pivot_cert is None
    port._ensure_pivot_free_certified()
    got = port._pivot_cert
    assert abs(got - want) <= 1e-4 * want, (got, want)
    assert 1.0 <= got < port.PIVOT_FREE_COND_BOUND / 1.3


class _IllConditionedRom:
    """Stand-in exposing what the port's certify_pivot_free touches (the
    reference test's _IllConditionedRom, tests/test_pivot_guard.py:38)."""

    PIVOT_FREE_COND_BOUND = 1e4

    def __init__(self, cond):
        N = 8
        self.grid = {"alpha": (0.1, 1.0)}
        d = np.logspace(0, np.log10(cond), N)
        self._K = np.diag(d / d[0])

        class _Fom:
            dt = 0.01
            domain = {"nt": 10}
            NT = "nt"

        self.fom = _Fom()

    def certify(self, **kw):
        return RomConstructorNonlinear.certify_pivot_free(self, **kw)

    def _guard_parts(self, mu, t):
        return self._K, self.fom.dt * self._K


def test_guard_refuses_ill_conditioned_family():
    rom = _IllConditionedRom(cond=1e8)
    with pytest.raises(ValueError, match="pivot-free online solve refused"):
        rom.certify()


def test_guard_passes_benign_family():
    rom = _IllConditionedRom(cond=10.0)
    cond = rom.certify()
    assert 1.0 <= cond < 20.0
    assert rom._pivot_cert == cond


def test_guard_off_and_without_global_basis(piston_cell, monkeypatch):
    """PIVOT_GUARD="off" skips the sweep; so does a configuration without
    a global basis (reference rom.py:937)."""
    _rom, payload = piston_cell
    port = serving_from_arrays(payload, device="cpu")
    calls = []
    monkeypatch.setattr(RomConstructorNonlinear, "certify_pivot_free",
                        lambda self, *a, **k: calls.append(1) or 1.0)
    port.PIVOT_GUARD = "off"
    port._ensure_pivot_free_certified()
    assert calls == []
    windows_only = serving_from_arrays(
        {k: v for k, v in payload.items() if not k.startswith("global_")},
        device="cpu")
    assert windows_only.global_serving is None
    windows_only._ensure_pivot_free_certified()
    assert calls == []
    port.PIVOT_GUARD = "auto"
    port._ensure_pivot_free_certified()
    assert calls == [1]


def test_guard_runs_once_before_the_first_sweep(piston_cell, monkeypatch):
    """The guard runs once per instance, before the first sweep of either
    engine; later batches are not checked again."""
    _rom, payload = piston_cell
    port = serving_from_arrays(payload, device="cpu")
    calls = []
    real = RomConstructorNonlinear.certify_pivot_free

    def spy(self, *a, **k):
        calls.append(1)
        return real(self, *a, **k)

    monkeypatch.setattr(RomConstructorNonlinear, "certify_pivot_free", spy)
    for seed in (1, 2):
        port.solve_batch(piston_mus(4, seed=seed), mode="probes")
    assert calls == [1] and port._pivot_cert >= 1.0


def test_bare_solve_batch_raises(piston_cell):
    """F1, closed: the reference's default mode, "reduced", runs its
    global lanes engine (rom.py:1168, :1262-1267). The port's bare
    ``solve_batch(mus)`` serves there where the payload has a global
    configuration (equal to the explicit engine="lanes" call), and raises
    ``ValueError`` where it has none."""
    rom, payload = piston_cell
    port = serving_from_arrays(payload_from_rom(rom, with_trilinear=True),
                               device="cpu")
    mus = piston_mus(2)
    assert port._resolve_engine("reduced", 2) == "lanes"
    out = port.solve_batch(mus)
    assert out["uN"].shape == (2, 96, port.global_serving.N)
    assert out["probes"].shape == (2, 96, 2)
    assert np.isfinite(out["uN"]).all() and np.isfinite(out["probes"]).all()
    forced = port.solve_batch(mus, mode="reduced", engine="lanes")
    for k in out:
        np.testing.assert_array_equal(out[k], forced[k], err_msg=k)
    bare = serving_from_arrays(
        {k: v for k, v in payload.items() if not k.startswith("global_")},
        device="cpu")
    with pytest.raises(ValueError, match="no global serving configuration"):
        bare.solve_batch(mus)


def test_payload_without_grid_is_refused(piston_cell):
    _rom, payload = piston_cell
    bare = {k: v for k, v in payload.items() if not k.startswith("grid_")}
    with pytest.raises(KeyError, match="grid_"):
        serving_from_arrays(bare, device="cpu")


@pytest.mark.parametrize("N", [12, 24, 32, 48])
@pytest.mark.parametrize("K8", [40, 56, 16 + 32 + 8 + PROBE_P])
def test_paired_lu_period_matches_reference_chunk(N, K8):
    for width in range(1, 151):
        assert paired_lu_period(width, K8, N) == _fused_chunk(width, K8, N), (
            width, K8, N)


@pytest.mark.parametrize("nt,N,period", [(60, 32, 30), (150, 24, 25)])
def test_serving_passes_the_period(monkeypatch, nt, N, period):
    """Two windows of width nt/2 on the fused branch, the paired schedule
    opted into (ROMTIME_PAIRED_LU=5): K1 gets the whole window at width
    30, N=32, and 25 at width 75, N=24."""
    monkeypatch.setenv("ROMTIME_PAIRED_LU", "5")
    from romtime_tpu_torch.rom.engines import windowed_fused as engine
    from romtime_tpu_torch.testing.synthetic import (
        synthetic_cell,
        synthetic_mus,
    )

    rom = synthetic_cell(seed=5, nx=60, nt=nt, n_windows=2, N=N, k=4,
                         device="cpu")
    rom.ONLINE_PRECOMPUTE_BUDGET = 0
    rom.WINDOWED_SOLVE_ITERS = None
    seen = []

    def spy(TH, *args, **kw):
        seen.append((kw["period"], kw["paired_lu"], kw["solve_iters"]))
        B = TH.shape[2]
        return (torch.zeros((TH.shape[0], PROBE_P, B)),
                torch.zeros((4, args[5].shape[2], B)))

    monkeypatch.setattr(engine, "online_sweep_windowed_fused", spy)
    rom.solve_batch(synthetic_mus(2, seed=1), mode="probes")
    assert seen == [(period, 5, None)]
    K8 = 8 + 16 + 8 + PROBE_P      # k=4: km8=8, kk8=16, kf8=8
    assert paired_lu_period(nt // 2, K8, N) == period
