"""K1 parity: the port's plain PyTorch twin of the fused windowed sweep
(romtime_tpu_torch/ops/windowed_fused.py) against the reference Pallas
kernel online_sweep_windowed_fused in interpret mode, on the reference
tests' synthetic serving tables (tests/test_pallas_online.py
_windowed_synthetic), at the reference tests' tolerances:

- N=12 (Gauss-Jordan) and N=24 (per-step blocked LU): atol 2e-5·scale
  (test_windowed_fused_matches_v2_chain);
- N=24 with paired LU G=5 "sub1" at width 8: atol 5e-5·scale
  (test_windowed_fused_paired_lu_matches). Width 8 ≥ G+2, so one
  leader/follower group really runs;
- the solve pieces against test_lanes_solve_panels_and_substitute.

The other follower modes are in tests/test_torch_follower_modes.py, the
``ablate`` variants in tests/test_torch_ablate.py. The CUDA kernel itself is held against the twin on the card
(tests/test_torch_cuda.py, marked ``cuda``; chip_smoke.py runs the same
comparison at serving shapes)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romtime_tpu.ops.pallas_online import (
    _chunk_capped,
    _lanes_solve,
    _lanes_solve_panels,
    _panels_substitute,
    online_sweep_windowed_fused as ref_sweep,
    pad_dim as ref_pad_dim,
)
from romtime_tpu_torch.ops import windowed_fused as k1
from test_pallas_online import PROBE_P, _windowed_synthetic

W, WIDTH, B = 3, 8, 128


def _tables(N, seed, smooth=False, with_trilinear=True):
    """Reference-layout K1 inputs as numpy f32 (the layouts of
    test_windowed_fused_paired_lu_matches)."""
    (thm, thk, thf, g, Bm, Bk, Bf, T0, VE, Tp, b0, dt,
     (km8, kk8, kf8)) = _windowed_synthetic(N, W, WIDTH, B, seed=seed)
    if smooth:
        for th in (thm, thk, thf):
            m = th.mean(axis=0, keepdims=True)
            th[:] = m + 0.05 * (th - m)
    NP = ref_pad_dim(N)
    g_p = np.zeros((W * WIDTH, PROBE_P, B), np.float32)
    g_p[:, :2, :] = g
    Bmk = np.concatenate([Bm, Bk] + ([T0] if with_trilinear else []),
                         axis=2)
    TQ = (T0.reshape(W, NP, NP * NP) if with_trilinear
          else np.zeros((W, 8, 8), np.float32))  # the reference's dummy
    BmF = (Bm.reshape(W, NP, NP, km8).transpose(0, 3, 1, 2)
           .reshape(W, km8 * NP, NP))
    BkF = (Bk.reshape(W, NP, NP, kk8).transpose(0, 3, 1, 2)
           .reshape(W, kk8 * NP, NP))
    args = [np.concatenate([thm, thk, thf, g_p], axis=1),
            Bmk.transpose(0, 2, 1), BmF.transpose(0, 2, 1),
            BkF.transpose(0, 2, 1), Bf.transpose(0, 2, 1),
            TQ, VE, Tp, b0[None, :],
            np.zeros((4, NP, B), np.float32)]
    args = [np.ascontiguousarray(a, np.float32) for a in args]
    kw = dict(widths=(WIDTH,) * W, dt=dt, bdf2=True,
              with_trilinear=with_trilinear, n_real=N, km8=km8, kk8=kk8,
              kf8=kf8)
    return args, kw


def _run_both(N, seed, atol_rel, paired_lu=None, smooth=False,
              with_trilinear=True):
    args, kw = _tables(N, seed, smooth, with_trilinear)
    ref_p, ref_s = ref_sweep(*[jnp.asarray(a) for a in args], **kw,
                             interpret=True, paired_lu=paired_lu)
    ref_p, ref_s = np.asarray(ref_p), np.asarray(ref_s)
    assert np.isfinite(ref_p).all() and np.isfinite(ref_s).all()
    launches = k1.online_sweep_windowed_fused.launches
    got_p, got_s = k1.online_sweep_windowed_fused(
        *[torch.from_numpy(a) for a in args], **kw, paired_lu=paired_lu,
        period=_chunk_capped(WIDTH, 8))
    # CPU tensors take the twin; only kernel launches are counted.
    assert k1.online_sweep_windowed_fused.launches == launches
    got_p, got_s = got_p.numpy(), got_s.numpy()
    assert got_p.shape == ref_p.shape and got_s.shape == ref_s.shape
    scale = max(np.abs(ref_p).max(), 1e-6)
    np.testing.assert_allclose(got_p, ref_p, rtol=0, atol=atol_rel * scale)
    sscale = np.abs(ref_s[[0, 2]]).max()
    np.testing.assert_allclose(got_s[[0, 2]], ref_s[[0, 2]], rtol=0,
                               atol=atol_rel * sscale)


@pytest.mark.parametrize("N", [12, 24], ids=["gauss_jordan", "blocked_lu"])
def test_twin_matches_reference_kernel(N):
    _run_both(N, seed=N, atol_rel=2e-5)


def test_twin_paired_lu_sub1_matches_reference_kernel():
    period = _chunk_capped(WIDTH, 8)
    roles = k1.step_roles(period, 5)
    assert roles.count("lead") == 1 and roles.count("follow") == 4, roles
    _run_both(24, seed=13, atol_rel=5e-5, paired_lu=5, smooth=True)


def test_twin_without_trilinear_matches_reference_kernel():
    _run_both(24, seed=7, atol_rel=5e-5, paired_lu=5, smooth=True,
              with_trilinear=False)


def test_step_roles_schedule():
    """Two full steps, groups of G, per-step remainder (reference
    pallas_online.py:1489-1548); no grouping without G ≥ 2."""
    assert k1.step_roles(30, 5) == (["full"] * 2
                                    + (["lead"] + ["follow"] * 4) * 5
                                    + ["full"] * 3)
    assert k1.step_roles(10, 5) == (["full"] * 2 + ["lead"]
                                    + ["follow"] * 4 + ["full"] * 3)
    assert k1.step_roles(8, None) == ["full"] * 8


def test_lanes_solve_pieces_match_reference():
    rng = np.random.default_rng(5)
    NP, BL, N = 24, 128, 22
    K = np.zeros((NP, NP, BL), np.float32)
    K[np.arange(NP), np.arange(NP)] = 1.0
    K[:N, :N] += 0.12 * rng.normal(size=(N, N, BL)).astype(np.float32)
    r = rng.normal(size=(NP, BL)).astype(np.float32)
    r[N:] = 0.0
    r2 = rng.normal(size=(NP, BL)).astype(np.float32)
    r2[N:] = 0.0
    Kt, rt, r2t = (torch.from_numpy(x.copy()) for x in (K, r, r2))

    delta_ref, panels_ref = _lanes_solve_panels(jnp.asarray(K),
                                                jnp.asarray(r), NP)
    delta, panels = k1.lanes_solve_panels(Kt, rt, NP)
    tol = 1e-5 * np.abs(np.asarray(delta_ref)).max()
    np.testing.assert_allclose(delta.numpy(), np.asarray(delta_ref),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(
        k1.lanes_solve(Kt, rt, N, NP).numpy(),
        np.asarray(_lanes_solve(jnp.asarray(K), jnp.asarray(r), N, NP)),
        rtol=0, atol=tol)
    assert np.all(delta.numpy()[N:] == 0.0)

    x_ref = np.asarray(_panels_substitute(panels_ref, jnp.asarray(r2), NP))
    x = k1.panels_substitute(panels, r2t, NP).numpy()
    np.testing.assert_allclose(x, x_ref, rtol=0,
                               atol=1e-5 * np.abs(x_ref).max())
    resid = k1.lanes_matvec(Kt, torch.from_numpy(x)).numpy() - r2
    assert np.abs(resid).max() < 1e-4 * np.abs(r2).max()


def test_gauss_jordan_matches_reference_small_n():
    rng = np.random.default_rng(3)
    NP, BL, N = 16, 128, 12
    K = np.zeros((NP, NP, BL), np.float32)
    K[np.arange(NP), np.arange(NP)] = 1.0
    K[:N, :N] += 0.15 * rng.normal(size=(N, N, BL)).astype(np.float32)
    r = rng.normal(size=(NP, BL)).astype(np.float32)
    r[N:] = 0.0
    want = np.asarray(_lanes_solve(jnp.asarray(K), jnp.asarray(r), N, NP))
    got = k1.lanes_solve(torch.from_numpy(K), torch.from_numpy(r), N,
                         NP).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_wrapper_rejects_bad_options():
    args, kw = _tables(24, seed=13)
    targs = [torch.from_numpy(a) for a in args]
    # An unknown follower mode raises and names the six (the reference
    # would serve "sub1" instead), with or without a paired group.
    for group in (5, None):
        with pytest.raises(ValueError, match="sub1, warm1, warm2, warmx, "
                                             "inv1, inv2"):
            k1.online_sweep_windowed_fused(*targs, **kw, paired_lu=group,
                                           paired_mode="off")
    with pytest.raises(ValueError, match="no_boundary"):
        k1.online_sweep_windowed_fused(*targs, **kw, ablate="no_trilinear")
    with pytest.raises(ValueError, match="divide"):
        k1.online_sweep_windowed_fused(*targs, **kw, period=3)
    with pytest.raises(ValueError, match="k offsets"):
        k1.online_sweep_windowed_fused(*targs, **dict(kw, km8=16))

