"""K1's ``ablate`` variants (the per-component cost ledger's probes): the
port's twin against the reference kernel online_sweep_windowed_fused in
interpret mode, for each ablation × solve (the LU schedule, and the
Richardson solve with 6 iterations) × N ∈ {12, 24} (Gauss-Jordan and
blocked LU). This mirrors tests/test_pallas_online.py
test_windowed_fused_ablate_variants_run (:608-665), on its damped
tables, but compares the values (2e-5·scale, the reference's limit for
the unablated sweep) instead of checking only that they are finite."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romtime_tpu.ops.pallas_online import (
    _chunk_capped,
    online_sweep_windowed_fused as ref_sweep,
)
from romtime_tpu_torch.ops import windowed_fused as k1
from test_torch_windowed_fused import WIDTH, _tables


@pytest.mark.parametrize("N", [12, 24])
@pytest.mark.parametrize("solve_iters", [None, 6], ids=["lu", "richardson"])
@pytest.mark.parametrize("ablate", k1.ABLATE_MODES)
def test_twin_ablate_matches_reference_kernel(ablate, solve_iters, N):
    args, kw = _tables(N, seed=7, smooth=True)
    ref_p, ref_s = ref_sweep(*[jnp.asarray(a) for a in args], **kw,
                             interpret=True, ablate=ablate,
                             solve_iters=solve_iters)
    ref_p, ref_s = np.asarray(ref_p), np.asarray(ref_s)
    assert np.isfinite(ref_p).all() and np.isfinite(ref_s).all()
    got_p, got_s = k1.online_sweep_windowed_fused(
        *[torch.from_numpy(a) for a in args], **kw, ablate=ablate,
        solve_iters=solve_iters, period=_chunk_capped(WIDTH, 8))
    got_p, got_s = got_p.numpy(), got_s.numpy()
    scale = max(np.abs(ref_p).max(), 1e-6)
    np.testing.assert_allclose(got_p, ref_p, rtol=0, atol=2e-5 * scale)
    sscale = np.abs(ref_s[[0, 2]]).max()
    np.testing.assert_allclose(got_s[[0, 2]], ref_s[[0, 2]], rtol=0,
                               atol=2e-5 * sscale)


def test_ablate_turns_pairing_off():
    """Any ablation runs every step as a per-step solve, as the reference
    does (pallas_online.py:1489-1490): the paired request changes
    nothing."""
    args, kw = _tables(24, seed=7, smooth=True)
    targs = [torch.from_numpy(a) for a in args]
    sweep = k1.online_sweep_windowed_fused
    plain = sweep(*targs, **kw, ablate="no_boundary")
    paired = sweep(*targs, **kw, ablate="no_boundary", paired_lu=3,
                   paired_mode="warmx")
    for a, b in zip(plain, paired):
        assert torch.equal(a, b)


def test_kernel_ledger_refuses_cpu_tensors():
    """The ledger times the kernel on the card; it never times the twin."""
    from romtime_tpu_torch.kernel_ledger import kernel_ledger

    args, kw = _tables(12, seed=7)
    with pytest.raises(ValueError, match="CUDA"):
        kernel_ledger([torch.from_numpy(a) for a in args], kw)


#: served setting → (rom.windowed_solve()'s triple, the first design's
#: ledger and unablated row at that setting, the Richardson ledger's
#: iterations).
SERVED = {"lu": ((None, None, "sub1"), "lu", "full", 5),
          "paired5_sub1": ((None, 5, "sub1"), "lu", "full_paired5", 5),
          "richardson3": ((3, None, "sub1"), "richardson", "full", 3)}


@pytest.mark.parametrize("solve", sorted(SERVED))
def test_kernel_ledger_components(monkeypatch, solve):
    """The ledger's variants, its components (clamped at 0 as bench.py
    clamps them) and bench.py's four keys at the served setting, with the
    sweep times replaced by fixed numbers: ``full_us_per_step`` from the
    unablated call through the wrapper at that setting (the serving
    design), the other three from the first design's rows at the same
    setting (bench.py:900-956), and ledger_lines naming each key's rows
    and design."""
    import types

    from romtime_tpu_torch import kernel_ledger as kl

    served, part, row, R = SERVED[solve]
    ms = {("full", None): 150.0, ("full_paired5", None): 120.0,
          ("no_solve", None): 60.0, ("no_dots", None): 90.0,
          ("no_boundary", None): 123.0, ("empty", None): 15.0,
          ("no_trilinear", None): 100.0, ("full", R): 100.0,
          ("no_solve", R): 70.0, ("no_dots", R): 40.0,
          ("no_boundary", R): 95.0, ("empty", R): 15.0,
          ("served", served[0]): 45.0}
    seen = []

    def fake_time(args, kw, reps, sweep=kl._first_design_sweep):
        if sweep is kl.online_sweep_windowed_fused:
            name = "served"
        elif kw["paired_lu"]:
            name = "full_paired5"
        else:
            name = kw["ablate"] or ("no_trilinear" if args[0].no_tri
                                    else "full")
        seen.append((name, kw["solve_iters"], kw["paired_lu"],
                     kw["paired_mode"]))
        return ms[(name, kw["solve_iters"])]

    monkeypatch.setattr(kl, "time_sweep", fake_time)
    th = types.SimpleNamespace(is_cuda=True, shape=(1500, 40, 2048),
                               no_tri=False)
    th_nt = types.SimpleNamespace(is_cuda=True, shape=(1500, 40, 2048),
                                  no_tri=True)
    kw = dict(paired_lu=5, paired_mode="warm1", solve_iters=3,
              ablate="empty", n_real=32)
    led = kl.kernel_ledger([th], kw, no_trilinear=([th_nt], dict(kw)),
                           served=served)
    assert len(seen) == 13 and all(m == "sub1" for *_x, m in seen)
    assert seen[-1] == ("served", served[0], served[1], "sub1")
    assert all(it == R for name, it, *_x in seen[7:12])
    assert led["lu"]["ms_per_sweep"]["no_trilinear"] == 100.0
    us = 1e3 / 1500
    lu = led["lu"]["components_us_per_step"]
    assert lu == pytest.approx({"theta_dots": 60 * us, "solve": 90 * us,
                                "trilinear": 50 * us, "boundary_dd": 27 * us,
                                "floor": 15 * us})
    rich = led["richardson"]["components_us_per_step"]
    assert rich == pytest.approx({"theta_dots": 60 * us, "solve": 30 * us,
                                  "boundary_dd": 5 * us, "floor": 15 * us})
    first = {("lu", "full"): (150.0, 123.0), ("lu", "full_paired5"):
             (120.0, 123.0), ("richardson", "full"): (100.0, 95.0)}
    full, no_boundary = first[(part, row)]
    no_solve = {"lu": 60.0, "richardson": 70.0}[part]
    assert led["served"]["design"] == "serving"
    assert (led["served"]["ledger"], led["served"]["row"]) == (part, row)
    assert led["bench"] == pytest.approx({
        "full_us_per_step": 45 * us,
        "solve_us_per_step": (full - no_solve) * us,
        "overhead_us_per_step": 15 * us,
        "dd_transfer_frac": max(full - no_boundary, 0.0) / full})
    line = [ln for ln in kl.ledger_lines(led, 2048)
            if "bench.py keys" in ln]
    assert len(line) == 1
    assert "the serving design, the served call" in line[0]
    assert f"the first design, {part} {row} − {part} no_solve" in line[0]
    assert f"{part} empty" in line[0]
