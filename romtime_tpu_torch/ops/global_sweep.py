"""Global-basis serving sweeps: K4 over materialized operator tables and
K5 over θ streams, in plain float32.

Counterparts of ``romtime_tpu/ops/pallas_online.py``
``online_sweep_pallas`` (:264, kernel ``_sweep_kernel`` :184) and
``online_sweep_theta_pallas`` (:413, kernel ``_theta_sweep_kernel`` :320).
This module holds

- the plain PyTorch twins :func:`sweep_reference` and
  :func:`theta_sweep_reference`, a lane-batched loop of torch ops over
  :func:`_bdf_step` (``_bdf_step`` :131, op for op);
- the wrappers :func:`online_sweep_pallas` and
  :func:`online_sweep_theta_pallas`, which run the twin for CPU tensors
  and the hand-written CUDA kernel (``csrc/global_sweep.cu``) for CUDA
  tensors. There is no fallback between the two.

Per step, for every lane (μ) b, from a zero state:

    combo = 2·uN − ½·uN₋₁,  u* = 2·uN − uN₋₁       (BDF-2; BDF-1: uN, uN)
    KN    = bdf·MN + KL + reshape(T0·u*)·dt·b0      (trilinear, optional)
    bN    = Σ_j MN[:, j]·combo[j] + fN
    uN    = Gauss-Jordan(KN, bN)                    (pivot-free, n_real rows)
    probes = VE·uN + g

bdf is 1 at step 0 and 1.5 after it (always 1 under BDF-1). K4 reads MN
(nt, NP, NP, B), KL and fN per step; K5 forms MN = Bm·θm, KL = Bk·θk and
fN = Bf·θf per step. The padded block of KN is the identity (KL carries 1
on the padded diagonal), so the padded entries of uN and the padded probe
rows stay exactly 0. The TPU tiling (128-lane blocks, DMA chunks, the
unroll caps) is not carried over: the kernels take any batch.
"""

import ctypes

import torch

from . import kernel_build
from .resid_sweep import _check_theta, _check_v2
from .windowed_fused import PROBE_P, _gauss_jordan, _no_tf32


# ======================================================================
# Plain PyTorch twins
# ======================================================================
def _bdf_step(MN, KL, fN, g, uN, uN1, step, T0, VE, dtb0, bdf2, n_real,
              NP):
    """One plain-f32 BDF step on (NP, NP, B) operators; ``dtb0`` is
    dt·b0 (B,), or None without the trilinear term. Returns (uN, probes)."""
    if bdf2:
        bdf = 1.0 if step == 0 else 1.5
        combo = 2.0 * uN - 0.5 * uN1
        u_star = 2.0 * uN - uN1
    else:
        bdf, combo, u_star = 1.0, uN, uN
    KN = bdf * MN + KL
    if dtb0 is not None:
        NN = (T0 @ u_star).reshape(NP, NP, -1)
        KN = KN + NN * dtb0[None, None, :]
    bN = (MN * combo[None, :, :]).sum(dim=1) + fN
    bN = _gauss_jordan(KN, bN, n_real)
    return bN, VE @ bN + g


def _sweep(operators, nt, g, T0, VE, b0, dt, bdf2, with_trilinear, n_real):
    """The twins' step loop from a zero state; ``operators(s)`` gives
    step s's (MN, KL, fN)."""
    NP = VE.shape[1]
    B = g.shape[2]
    if g.is_cuda:
        _no_tf32()
    dtb0 = None
    if with_trilinear:
        dtb0 = torch.tensor(dt, dtype=g.dtype, device=g.device) * b0[0]
    probes = g.new_empty((nt, PROBE_P, B))
    uN = g.new_zeros((NP, B))
    uN1 = uN
    for s in range(nt):
        MN, KL, fN = operators(s)
        uN_new, probes[s] = _bdf_step(MN, KL, fN, g[s], uN, uN1, s, T0, VE,
                                      dtb0, bdf2, n_real, NP)
        uN1, uN = uN, uN_new
    return probes, uN


def sweep_reference(MN_p, KL_p, fN_p, g_p, T0_p, VE_p, b0, *, dt,
                    bdf2=True, with_trilinear=True, n_real=15):
    """Plain PyTorch twin of K4; same arguments and results as
    :func:`online_sweep_pallas`."""
    nt, _NP, _B = _check_v2(MN_p, KL_p, fN_p, g_p, T0_p, VE_p, b0, None,
                            with_trilinear, n_real)
    return _sweep(lambda s: (MN_p[s], KL_p[s], fN_p[s]), nt, g_p, T0_p,
                  VE_p, b0, dt, bdf2, with_trilinear, n_real)


def theta_sweep_reference(THm, THk, THf, g_p, Bm, Bk, Bf, T0_p, VE_p, b0,
                          *, dt, bdf2=True, with_trilinear=True, n_real=15):
    """Plain PyTorch twin of K5; same arguments and results as
    :func:`online_sweep_theta_pallas`."""
    nt, NP, B, *_k = _check_theta(THm, THk, THf, g_p, Bm, Bk, Bf, T0_p,
                                  VE_p, b0, None, with_trilinear, n_real)
    if THm.is_cuda:
        _no_tf32()

    def operators(s):
        return ((Bm @ THm[s]).reshape(NP, NP, B),
                (Bk @ THk[s]).reshape(NP, NP, B), Bf @ THf[s])

    return _sweep(operators, nt, g_p, T0_p, VE_p, b0, dt, bdf2,
                  with_trilinear, n_real)


# ======================================================================
# CUDA kernels: bind, launch (built by kernel_build)
# ======================================================================
def _bind(lib):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.romtime_global_sweep.argtypes = (
        [ptr] * 9 + [i32] * 6 + [ctypes.c_float, ptr])
    lib.romtime_global_sweep.restype = i32
    lib.romtime_theta_global_sweep.argtypes = (
        [ptr] * 12 + [i32] * 9 + [ctypes.c_float, ptr])
    lib.romtime_theta_global_sweep.restype = i32


def online_sweep_pallas(MN_p, KL_p, fN_p, g_p, T0_p, VE_p, b0, *, dt,
                        bdf2=True, with_trilinear=True, n_real=15):
    """Plain-f32 global sweep over materialized per-step operators (K4).

    MN_p, KL_p : (nt, NP, NP, B) mass and dt-scaled stiffness-side
                 operators (KL carries the identity on the padded diagonal)
    fN_p       : (nt, NP, B) dt-scaled right-hand side
    g_p        : (nt, PROBE_P, B) lifting probes
    T0_p       : (NP², NP) trilinear tensor (ignored without it)
    VE_p       : (PROBE_P, NP) probe rows;  b0 : (1, B) trilinear coefficient

    Returns (probes (nt, PROBE_P, B), uN_final (NP, B)), float32, from a
    zero state. CPU tensors run the twin; CUDA tensors launch the kernel
    (and count the launch in ``online_sweep_pallas.launches``)."""
    kw = dict(dt=dt, bdf2=bdf2, with_trilinear=with_trilinear,
              n_real=n_real)
    if kernel_build.device_route(MN_p) == "cpu":
        return sweep_reference(MN_p, KL_p, fN_p, g_p, T0_p, VE_p, b0, **kw)
    nt, NP, B = _check_v2(MN_p, KL_p, fN_p, g_p, T0_p, VE_p, b0, None,
                          with_trilinear, n_real)
    if not with_trilinear:
        T0_p = MN_p.new_zeros((1,))
    out = kernel_build.launch(
        "global_sweep", _bind, "romtime_global_sweep", "global_sweep (K4)",
        list(zip(("MN", "KL", "fN", "g", "T0", "VE", "b0"),
                 (MN_p, KL_p, fN_p, g_p, T0_p, VE_p, b0))),
        (nt, NP, B, n_real, int(bool(with_trilinear)), int(bool(bdf2))),
        dt, [(nt, PROBE_P, B), (NP, B)])
    online_sweep_pallas.launches += 1
    return out


def online_sweep_theta_pallas(THm, THk, THf, g_p, Bm, Bk, Bf, T0_p, VE_p,
                              b0, *, dt, bdf2=True, with_trilinear=True,
                              n_real=15):
    """θ-streaming global sweep (K5): as :func:`online_sweep_pallas`, with
    the step's operators formed in the kernel from

    THm, THk, THf : (nt, km8|kk8|kf8, B) θ streams (8-aligned row counts;
                    THk ends in the constant-1 row of the padded diagonal)
    Bm, Bk        : (NP², km8|kk8) combine tensors (dt folded into Bk)
    Bf            : (NP, kf8) (dt folded)

    CUDA launches are counted in ``online_sweep_theta_pallas.launches``."""
    kw = dict(dt=dt, bdf2=bdf2, with_trilinear=with_trilinear,
              n_real=n_real)
    if kernel_build.device_route(THm) == "cpu":
        return theta_sweep_reference(THm, THk, THf, g_p, Bm, Bk, Bf, T0_p,
                                     VE_p, b0, **kw)
    nt, NP, B, km8, kk8, kf8 = _check_theta(
        THm, THk, THf, g_p, Bm, Bk, Bf, T0_p, VE_p, b0, None,
        with_trilinear, n_real)
    if not with_trilinear:
        T0_p = THm.new_zeros((1,))
    out = kernel_build.launch(
        "global_sweep", _bind, "romtime_theta_global_sweep",
        "theta global_sweep (K5)",
        list(zip(("THm", "THk", "THf", "g", "Bm", "Bk", "Bf", "T0", "VE",
                  "b0"),
                 (THm, THk, THf, g_p, Bm, Bk, Bf, T0_p, VE_p, b0))),
        (nt, NP, B, km8, kk8, kf8, n_real, int(bool(with_trilinear)),
         int(bool(bdf2))), dt, [(nt, PROBE_P, B), (NP, B)])
    online_sweep_theta_pallas.launches += 1
    return out


online_sweep_pallas.launches = 0
online_sweep_theta_pallas.launches = 0
