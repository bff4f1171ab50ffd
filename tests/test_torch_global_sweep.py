"""K4/K5 parity: the port's plain PyTorch twins of the global-basis
sweeps (romtime_tpu_torch/ops/global_sweep.py) against the reference
Pallas kernels online_sweep_pallas and online_sweep_theta_pallas in
interpret mode, on the reference tests' synthetic tables
(tests/test_pallas_online.py ``_synthetic``), at the reference tests'
tolerances:

- BDF-2 with the trilinear term at N=15: probes within
  2e-6·max(scale, 1), uN within 1e-5, padded probe rows and uN entries
  exactly 0 (test_fused_sweep_matches_scan,
  test_theta_streaming_matches_scan);
- BDF-1 without it at N=9: within 5e-5·max(scale, 1)
  (test_fused_sweep_bdf1_no_trilinear);
- N=20 (NP=24), which the reference marks slow, against a float64 numpy
  recursion instead, at the first tolerance;
- a batch that is not a multiple of 128 (the reference kernels refuse
  it; the twins and kernels take any batch), twin only.

The CUDA kernels themselves are held against the twins on the card
(tests/test_torch_cuda.py, marked ``cuda``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romtime_tpu.ops.pallas_online import (
    PROBE_P,
    online_sweep_pallas as ref_k4,
    online_sweep_theta_pallas as ref_k5,
    pad_dim,
    pad_reduced_tables as ref_pad_reduced_tables,
)
from romtime_tpu_torch.ops import global_sweep as gs
from test_pallas_online import _synthetic


def _padded_common(case, N, NT, B):
    _MN, _KL, _fN, g_t, T0, b0, VE, _dt = case
    NP = pad_dim(N)
    g_p = np.zeros((NT, PROBE_P, B), np.float32)
    g_p[:, :2] = g_t
    T0_p = np.zeros((NP, NP, NP), np.float32)
    T0_p[:N, :N, :N] = T0.reshape(N, N, N)
    VE_p = np.zeros((PROBE_P, NP), np.float32)
    VE_p[:2, :N] = VE
    return [g_p, T0_p.reshape(NP * NP, NP), VE_p, b0[None, :]]


def _k4_args(case, N, NT, B):
    MN, KL, fN = (np.array(x) for x in ref_pad_reduced_tables(
        *(jnp.asarray(a) for a in case[:3]), N))
    return [MN, KL, fN] + _padded_common(case, N, NT, B)


def _k5_args(case, N, NT, B):
    """The exact θ factorization of test_theta_streaming_matches_scan:
    identity bases over the N² (N) real entries, the padded diagonal on a
    constant-1 θk row."""
    MN_t, KL_t, fN_t = case[:3]
    NP = pad_dim(N)
    pos = (np.arange(N)[:, None] * NP + np.arange(N)[None, :]).ravel()

    def factor(tab, rows, k8, extra=0):
        th = np.zeros((NT, k8, B), np.float32)
        th[:, :rows] = tab
        basis = np.zeros((k8, rows), np.float32)
        basis[np.arange(rows), np.arange(rows)] = 1.0
        return basis, th

    k8 = -(-(N * N) // 8) * 8
    kk8 = -(-(N * N + 1) // 8) * 8
    Im, THm = factor(MN_t, N * N, k8)
    Bm = np.zeros((NP * NP, k8), np.float32)
    Bm[pos] = Im.T
    Ik, THk = factor(KL_t, N * N, kk8)
    THk[:, N * N] = 1.0
    Bk = np.zeros((NP * NP, kk8), np.float32)
    Bk[pos] = Ik.T
    Bk[np.arange(N, NP) * NP + np.arange(N, NP), N * N] = 1.0
    If, THf = factor(fN_t, N, -(-N // 8) * 8)
    Bf = np.zeros((NP, THf.shape[1]), np.float32)
    Bf[:N] = If.T
    g_p, T0_p, VE_p, b0 = _padded_common(case, N, NT, B)
    return [THm, THk, THf, g_p, Bm, Bk, Bf, T0_p, VE_p, b0]


def _run(kernel, N, NT, B, seed, **kw):
    """(port (probes, uN), reference (probes, uN)) on the same inputs:
    the reference kernel in interpret mode, the port's wrapper on CPU
    tensors (its twin; no launch is counted)."""
    case = _synthetic(N, NT, B, seed=seed)
    build, port_fn, ref_fn = {"k4": (_k4_args, gs.online_sweep_pallas,
                                     ref_k4),
                              "k5": (_k5_args, gs.online_sweep_theta_pallas,
                                     ref_k5)}[kernel]
    args = build(case, N, NT, B)
    kw = dict(dt=case[-1], n_real=N, **kw)
    ref = ref_fn(*[jnp.asarray(a) for a in args], interpret=True, **kw)
    counters = (gs.online_sweep_pallas.launches,
                gs.online_sweep_theta_pallas.launches)
    got = port_fn(*[torch.from_numpy(np.array(a)) for a in args], **kw)
    assert (gs.online_sweep_pallas.launches,
            gs.online_sweep_theta_pallas.launches) == counters
    return [t.numpy() for t in got], [np.asarray(a) for a in ref]


@pytest.mark.parametrize("kernel", ["k4", "k5"])
def test_twin_matches_reference_kernel(kernel):
    N, NT, B = 15, 24, 128
    (probes, uN), (ref_p, ref_u) = _run(kernel, N, NT, B,
                                        seed=N if kernel == "k4" else N + 7)
    assert np.isfinite(ref_p).all() and np.isfinite(ref_u).all()
    scale = float(np.abs(ref_p).max())
    err = np.abs(probes[:, :2] - ref_p[:, :2]).max()
    print(f"{kernel} N={N}: probes err {err:.3e} (scale {scale:.3e})")
    np.testing.assert_allclose(probes[:, :2], ref_p[:, :2], rtol=0,
                               atol=2e-6 * max(scale, 1.0))
    np.testing.assert_allclose(uN[:N], ref_u[:N], rtol=0, atol=1e-5)
    assert np.abs(probes[:, 2:]).max() == 0.0
    assert np.abs(uN[N:]).max() == 0.0


@pytest.mark.parametrize("kernel", ["k4", "k5"])
def test_twin_bdf1_no_trilinear(kernel):
    N, NT, B = 9, 16, 128
    (probes, uN), (ref_p, ref_u) = _run(kernel, N, NT, B, seed=3,
                                        bdf2=False, with_trilinear=False)
    scale = float(np.abs(ref_p).max())
    np.testing.assert_allclose(probes[:, :2], ref_p[:, :2], rtol=0,
                               atol=5e-5 * max(scale, 1.0))
    np.testing.assert_allclose(uN, ref_u, rtol=0,
                               atol=5e-5 * max(np.abs(ref_u).max(), 1.0))


def _f64_recursion(case, N, B, bdf2=True, with_trilinear=True):
    """The reference tests' scan (_ref_scan) in float64 with a direct
    solve: (probes (NT, 2, B), uN (N, B))."""
    MN_t, KL_t, fN_t, g_t, T0, b0, VE, dt = (np.float64(a) for a in case)
    NT = MN_t.shape[0]
    uN = np.zeros((N, B))
    uN1 = np.zeros((N, B))
    probes = []
    for k in range(NT):
        MN = MN_t[k].reshape(N, N, B)
        bdf = 1.5 if bdf2 and k > 0 else 1.0
        combo, u_star = ((2 * uN - 0.5 * uN1, 2 * uN - uN1) if bdf2
                         else (uN, uN))
        K = bdf * MN + KL_t[k].reshape(N, N, B)
        if with_trilinear:
            K = K + (T0 @ u_star).reshape(N, N, B) * (dt * b0)[None, None]
        bN = np.einsum("ijB,jB->iB", MN, combo) + fN_t[k]
        u = np.linalg.solve(K.transpose(2, 0, 1), bN.T[..., None])[..., 0].T
        uN1, uN = uN, u
        probes.append(VE @ uN + g_t[k])
    return np.array(probes), uN


def _f64_inputs(kernel, N, NT, B, seed):
    case = _synthetic(N, NT, B, seed=seed)
    args = (_k4_args if kernel == "k4" else _k5_args)(case, N, NT, B)
    fn = (gs.online_sweep_pallas if kernel == "k4"
          else gs.online_sweep_theta_pallas)
    return case, args, fn


@pytest.mark.parametrize("kernel", ["k4", "k5"])
@pytest.mark.parametrize("N,B", [(20, 128), (15, 130)],
                         ids=["N20_NP24", "ragged_batch"])
def test_twin_matches_f64_recursion(kernel, N, B):
    """N=20 (the reference's slow case) and a batch that is not a
    multiple of 128, against the float64 recursion."""
    NT = 24
    case, args, fn = _f64_inputs(kernel, N, NT, B, seed=N + 40)
    probes, uN = fn(*[torch.from_numpy(np.array(a)) for a in args],
                    dt=case[-1], n_real=N)
    want_p, want_u = _f64_recursion(case, N, B)
    scale = float(np.abs(want_p).max())
    err = np.abs(probes.numpy()[:, :2] - want_p).max()
    print(f"{kernel} N={N} B={B}: probes err {err:.3e} vs f64 "
          f"(scale {scale:.3e})")
    assert err <= 2e-6 * max(scale, 1.0), err
    np.testing.assert_allclose(uN.numpy()[:N], want_u, rtol=0, atol=1e-5)
    assert np.abs(probes.numpy()[:, 2:]).max() == 0.0
    assert np.abs(uN.numpy()[N:]).max() == 0.0


def test_wrappers_reject_bad_input():
    N, NT, B = 9, 4, 16
    case = _synthetic(N, NT, B, seed=5)
    args = [torch.from_numpy(np.array(a)) for a in _k4_args(case, N, NT, B)]
    kw = dict(dt=case[-1], n_real=N)
    with pytest.raises(ValueError, match="MN/KL"):
        gs.online_sweep_pallas(args[0][:, :8], *args[1:], **kw)
    with pytest.raises(ValueError, match="n_real"):
        gs.online_sweep_pallas(*args, dt=case[-1], n_real=17)
    with pytest.raises(ValueError, match="unsupported device"):
        gs.online_sweep_pallas(*[a.to("meta") for a in args], **kw)
    # NP = 72 is past the largest padded size the kernels hold (64).
    big = [torch.zeros((NT, 72, 72, B)), torch.zeros((NT, 72, 72, B)),
           torch.zeros((NT, 72, B)), args[3], torch.zeros((72 * 72, 72)),
           torch.zeros((PROBE_P, 72)), args[6]]
    with pytest.raises(ValueError, match="at most 64"):
        gs.online_sweep_pallas(*big, **kw)
    targs = [torch.from_numpy(np.array(a)) for a in _k5_args(case, N, NT, B)]
    with pytest.raises(ValueError, match="8-aligned"):
        gs.online_sweep_theta_pallas(targs[0][:, :5], *targs[1:], **kw)
