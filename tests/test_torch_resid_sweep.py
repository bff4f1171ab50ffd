"""K2/K3 parity: the port's plain PyTorch twins of the residual-form
per-window sweeps (romtime_tpu_torch/ops/resid_sweep.py) against the
reference Pallas kernels online_sweep_pallas_v2 and
online_sweep_theta_pallas_v2 in interpret mode, on the reference tests'
synthetic tables (tests/test_pallas_online.py), at the reference tests'
tolerances:

- twin vs reference kernel: 2e-5·scale on probes and state
  (test_windowed_fused_matches_v2_chain);
- twin vs the float64 recursion: below 5e-6
  (test_v2_residual_sweep_and_chaining,
  test_v2_fori_gauss_jordan_matches_reference), for K3 too, where the
  reference's own test allows 2e-5 (test_theta_v2_fori_steps_blocked_gj);
- two chained launches (state in/out, step0 offset) equal one launch
  exactly (test_v2_residual_sweep_and_chaining).

N=12 runs the Gauss-Jordan solve, N=24 the blocked LU. The CUDA kernels
themselves are held against the twins on the card
(tests/test_torch_cuda.py, marked ``cuda``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romtime_tpu.ops.pallas_online import (
    PROBE_P,
    online_sweep_pallas_v2 as ref_v2,
    online_sweep_theta_pallas_v2 as ref_theta_v2,
    pad_dim,
    pad_reduced_tables as ref_pad_reduced_tables,
)
from romtime_tpu_torch.ops import resid_sweep as rs

B = 128


def _operators(N, NT, seed):
    """Materialized per-step operators of test_v2_residual_sweep_and_chaining
    (float64, unpadded)."""
    rng = np.random.default_rng(seed)
    dt = 1.0 / NT
    eye = np.eye(N)
    MN = 0.05 * rng.normal(size=(NT, N, N, B)) + eye[None, :, :, None]
    KL = (0.02 * rng.normal(size=(NT, N, N, B))
          + 2.0 * eye[None, :, :, None]) * dt
    fN = 0.1 * dt * rng.normal(size=(NT, N, B))
    return dict(MN=MN, KL=KL, fN=fN, dt=dt, **_common(rng, N, NT))


def _common(rng, N, NT):
    return dict(g=0.01 * rng.normal(size=(NT, 2, B)),
                T0=0.05 * rng.normal(size=(N * N, N)),
                b0=1.0 + 0.1 * rng.normal(size=(B,)),
                VE=rng.normal(size=(2, N)))


def _f64_recursion(ops, case, N, NT):
    """Plain float64 BDF-2 recursion with the trilinear term on unpadded
    per-step operators ``ops(k)`` = (MN, KL, fN), the reference tests'
    ground truth."""
    uN = np.zeros((N, B))
    uN1 = np.zeros((N, B))
    probes = []
    for k in range(NT):
        MN, KL, fN = ops(k)
        bdf = 1.0 if k == 0 else 1.5
        u_star = 2 * uN - uN1
        NN = (case["T0"] @ u_star).reshape(N, N, B) * (
            case["dt"] * case["b0"])[None, None, :]
        K = bdf * MN + KL + NN
        combo = 2 * uN - 0.5 * uN1
        bN = np.einsum("ijB,jB->iB", MN, combo) + fN
        u = np.stack([np.linalg.solve(K[:, :, b], bN[:, b])
                      for b in range(B)], 1)
        uN1, uN = uN, u
        probes.append(case["VE"] @ uN + case["g"][k])
    return np.array(probes)


def _padded_common(case, N):
    NP = pad_dim(N)
    NT = case["g"].shape[0]
    g_p = np.zeros((NT, PROBE_P, B), np.float32)
    g_p[:, :2] = case["g"]
    T0 = np.zeros((NP, NP, NP), np.float32)
    T0[:N, :N, :N] = case["T0"].reshape(N, N, N)
    VE = np.zeros((PROBE_P, NP), np.float32)
    VE[:2, :N] = case["VE"]
    return [g_p, T0.reshape(NP * NP, NP), VE,
            np.asarray(case["b0"], np.float32)[None, :]]


def _k2_args(case, N):
    NT = case["MN"].shape[0]
    MN, KL, fN = (np.array(x) for x in ref_pad_reduced_tables(
        *(jnp.asarray(case[k].reshape(NT, -1, B), jnp.float32)
          for k in ("MN", "KL", "fN")), N))
    return [MN, KL, fN] + _padded_common(case, N)


def _theta_case(N, NT, seed):
    """θ-parametrized operators of test_theta_v2_fori_steps_blocked_gj."""
    rng = np.random.default_rng(seed)
    NP = pad_dim(N)
    km8, kk8, kf8 = 8, 16, 8
    dt = 1.0 / NT
    thm = rng.normal(size=(NT, km8, B)) * 0.1
    thm[:, 0, :] = 1.0 + 0.05 * rng.normal(size=(NT, B))
    thk = rng.normal(size=(NT, kk8, B)) * 0.1
    thk[:, 0, :] = 1.0 + 0.05 * rng.normal(size=(NT, B))
    thf = rng.normal(size=(NT, kf8, B))
    Bm = np.zeros((NP, NP, km8), np.float32)
    Bm[:N, :N] = 0.02 * rng.normal(size=(N, N, km8))
    Bm[np.arange(N), np.arange(N), 0] += 1.0
    Bk = np.zeros((NP, NP, kk8), np.float32)
    Bk[:N, :N] = 0.01 * dt * rng.normal(size=(N, N, kk8))
    Bk[np.arange(N), np.arange(N), 0] += 2.0 * dt
    Bk[np.arange(N, NP), np.arange(N, NP), 0] = 1.0
    Bf = np.zeros((NP, kf8), np.float32)
    Bf[:N] = 0.1 * dt * rng.normal(size=(N, kf8))
    th = [np.asarray(x, np.float32) for x in (thm, thk, thf)]
    return dict(th=th, Bm=Bm, Bk=Bk, Bf=Bf, dt=dt, **_common(rng, N, NT))


def _k3_args(case, N):
    NP = pad_dim(N)
    g_p, T0, VE, b0 = _padded_common(case, N)
    return case["th"] + [g_p, case["Bm"].reshape(NP * NP, -1),
                         case["Bk"].reshape(NP * NP, -1), case["Bf"],
                         T0, VE, b0]


def _state0(N):
    return np.zeros((4, pad_dim(N), B), np.float32)


def _assert_close(got, want, atol_rel):
    (gp, gs), (wp, ws) = got, want
    assert gp.shape == wp.shape and gs.shape == ws.shape
    assert np.isfinite(wp).all() and np.isfinite(ws).all()
    scale = max(np.abs(wp).max(), 1e-6)
    np.testing.assert_allclose(gp, wp, rtol=0, atol=atol_rel * scale)
    sscale = np.abs(ws[[0, 2]]).max()
    np.testing.assert_allclose(gs[[0, 2]], ws[[0, 2]], rtol=0,
                               atol=atol_rel * sscale)


def _run(port_fn, ref_fn, args, **kw):
    """The same numpy inputs through the reference kernel (interpret
    mode) and the port's wrapper on CPU tensors (its twin)."""
    ref = ref_fn(*[jnp.asarray(a) for a in args], interpret=True, **kw)
    counters = (rs.online_sweep_pallas_v2.launches,
                rs.online_sweep_theta_pallas_v2.launches)
    got = port_fn(*[torch.from_numpy(np.array(a))
                    for a in args], **kw)
    # CPU tensors take the twin; only kernel launches are counted.
    assert (rs.online_sweep_pallas_v2.launches,
            rs.online_sweep_theta_pallas_v2.launches) == counters
    return ([t.numpy() for t in got], [np.asarray(a) for a in ref])


OPTIONS = [{}, {"with_trilinear": False}, {"bdf2": False}]
OPTION_IDS = ["bdf2_trilinear", "no_trilinear", "bdf1"]


@pytest.mark.parametrize("options", OPTIONS, ids=OPTION_IDS)
@pytest.mark.parametrize("N", [12, 24], ids=["gauss_jordan", "blocked_lu"])
def test_k2_twin_matches_reference_kernel(N, options):
    case = _operators(N, 32, seed=N)
    args = _k2_args(case, N) + [_state0(N)]
    kw = dict(dt=case["dt"], step0=0, n_real=N, **options)
    got, want = _run(rs.online_sweep_pallas_v2, ref_v2, args, **kw)
    _assert_close(got, want, 2e-5)


@pytest.mark.parametrize("options", OPTIONS, ids=OPTION_IDS)
@pytest.mark.parametrize("N", [12, 24], ids=["gauss_jordan", "blocked_lu"])
def test_k3_twin_matches_reference_kernel(N, options):
    case = _theta_case(N, 24, seed=N + 1)
    args = _k3_args(case, N) + [_state0(N)]
    kw = dict(dt=case["dt"], step0=0, n_real=N, **options)
    got, want = _run(rs.online_sweep_theta_pallas_v2, ref_theta_v2, args,
                     **kw)
    _assert_close(got, want, 2e-5)


@pytest.mark.parametrize("N", [12, 24], ids=["gauss_jordan", "blocked_lu"])
def test_k2_twin_matches_f64_recursion(N):
    """The point of the residual form: the f32 twin lands within 5e-6 of
    the float64 plain recursion."""
    NT = 32
    case = _operators(N, NT, seed=N + 100)
    want = _f64_recursion(
        lambda k: (case["MN"][k], case["KL"][k], case["fN"][k]), case, N, NT)
    args = _k2_args(case, N) + [_state0(N)]
    probes, _state = rs.online_sweep_pallas_v2(
        *[torch.from_numpy(a) for a in args], dt=case["dt"], n_real=N)
    err = np.abs(probes.numpy()[:, :2] - want).max()
    assert err < 5e-6, err


@pytest.mark.parametrize("N", [12, 24], ids=["gauss_jordan", "blocked_lu"])
def test_k3_twin_matches_f64_recursion(N):
    NT = 24
    case = _theta_case(N, NT, seed=N + 200)
    thm, thk, thf = (np.float64(t) for t in case["th"])
    Bm, Bk = (np.float64(case[k][:N, :N]) for k in ("Bm", "Bk"))
    Bf = np.float64(case["Bf"][:N])

    def ops(k):
        return (np.einsum("ijk,kB->ijB", Bm, thm[k]),
                np.einsum("ijk,kB->ijB", Bk, thk[k]),
                np.einsum("ik,kB->iB", Bf, thf[k]))

    want = _f64_recursion(ops, case, N, NT)
    args = _k3_args(case, N) + [_state0(N)]
    probes, _state = rs.online_sweep_theta_pallas_v2(
        *[torch.from_numpy(a) for a in args], dt=case["dt"], n_real=N)
    err = np.abs(probes.numpy()[:, :2] - want).max()
    assert err < 5e-6, err


@pytest.mark.parametrize("kernel", ["k2", "k3"])
def test_chained_launches_equal_one_launch(kernel):
    """Two launches chained through the dd state with a step0 offset
    reproduce the single launch exactly."""
    N, NT = 12, 24
    if kernel == "k2":
        case = _operators(N, NT, seed=3)
        args = [torch.from_numpy(a) for a in _k2_args(case, N)]
        fn = rs.online_sweep_pallas_v2
    else:
        case = _theta_case(N, NT, seed=4)
        args = [torch.from_numpy(a) for a in _k3_args(case, N)]
        fn = rs.online_sweep_theta_pallas_v2
    stepped = range(4)   # the three per-step tables and g lead the args
    kw = dict(dt=case["dt"], n_real=N)
    state0 = torch.from_numpy(_state0(N))
    p1, s1 = fn(*args, state0, step0=0, **kw)
    h = NT // 2

    def part(lo, hi):
        return [a[lo:hi] if i in stepped else a for i, a in enumerate(args)]

    pa, sa = fn(*part(0, h), state0, step0=0, **kw)
    pb, sb = fn(*part(h, NT), sa, step0=h, **kw)
    np.testing.assert_array_equal(torch.cat([pa, pb]).numpy(), p1.numpy())
    np.testing.assert_array_equal(sb.numpy(), s1.numpy())


def test_pad_reduced_tables_matches_reference():
    N, NT = 10, 4
    case = _operators(N, NT, seed=5)
    tabs = [case[k].reshape(NT, -1, B).astype(np.float32)
            for k in ("MN", "KL", "fN")]
    want = ref_pad_reduced_tables(*(jnp.asarray(t) for t in tabs), N)
    got = rs.pad_reduced_tables(*(torch.from_numpy(t) for t in tabs), N)
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))


def test_wrappers_reject_bad_input():
    N = 12
    case = _operators(N, 4, seed=6)
    args = [torch.from_numpy(a) for a in _k2_args(case, N)]
    state0 = torch.from_numpy(_state0(N))
    with pytest.raises(ValueError, match="MN/KL"):
        rs.online_sweep_pallas_v2(args[0][:, :8], *args[1:], state0,
                                  dt=case["dt"], n_real=N)
    with pytest.raises(ValueError, match="n_real"):
        rs.online_sweep_pallas_v2(*args, state0, dt=case["dt"], n_real=17)
    with pytest.raises(ValueError, match="unsupported device"):
        rs.online_sweep_pallas_v2(*[a.to("meta") for a in args],
                                  state0.to("meta"), dt=case["dt"],
                                  n_real=N)
    tcase = _theta_case(N, 4, seed=7)
    targs = [torch.from_numpy(a) for a in _k3_args(tcase, N)]
    with pytest.raises(ValueError, match="8-aligned"):
        rs.online_sweep_theta_pallas_v2(targs[0][:, :5], *targs[1:], state0,
                                        dt=tcase["dt"], n_real=N)
