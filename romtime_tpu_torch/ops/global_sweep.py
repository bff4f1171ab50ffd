"""Global-basis serving sweeps: K4 over materialized operator tables and
K5 over θ streams, in plain float32.

Counterparts of ``romtime_tpu/ops/pallas_online.py``
``online_sweep_pallas`` (:264, kernel ``_sweep_kernel`` :184) and
``online_sweep_theta_pallas`` (:413, kernel ``_theta_sweep_kernel`` :320).
This module holds

- the plain PyTorch twins :func:`sweep_reference` and
  :func:`theta_sweep_reference`, a lane-batched loop of torch ops over
  :func:`_bdf_step` (``_bdf_step`` :131, op for op);
- :func:`sweep_split` and :func:`theta_sweep_split`, K4 and K5 in the
  serving body's arithmetic (the plain-f32 step form of
  :func:`~.windowed_fused.split_combine`);
- the wrappers :func:`online_sweep_pallas` and
  :func:`online_sweep_theta_pallas`, which run the twin for CPU tensors
  and a hand-written CUDA kernel for CUDA tensors: the serving body's
  plain-f32 step, over materialized tables for K4
  (``csrc/global_tables_serving.cu``) and over θ for K5
  (``csrc/global_serving.cu``), for every call; their first designs
  (``csrc/global_sweep.cu``) only on an explicit request
  (:func:`~.resid_sweep.theta_design`). There is no fallback between any
  of them.

Per step, for every lane (μ) b, from a zero state:

    combo = 2·uN − ½·uN₋₁,  u* = 2·uN − uN₋₁       (BDF-2; BDF-1: uN, uN)
    KN    = bdf·MN + KL + reshape(T0·u*)·dt·b0      (trilinear, optional)
    bN    = Σ_j MN[:, j]·combo[j] + fN
    uN    = Gauss-Jordan(KN, bN)                    (pivot-free, n_real rows)
    probes = VE·uN + g

bdf is 1 at step 0 and 1.5 after it (always 1 under BDF-1). K4 reads MN
(nt, NP, NP, B), KL and fN per step; K5 forms MN = Bm·θm, KL = Bk·θk and
fN = Bf·θf per step; K4's serving body reads its tables lane-major
(:func:`~.resid_sweep.lane_major`, ``lane_major=True`` from the engine).
The padded block of KN is the identity (KL carries 1
on the padded diagonal), so the padded entries of uN and the padded probe
rows stay exactly 0. The TPU tiling (128-lane blocks, DMA chunks, the
unroll caps) is not carried over: the kernels take any batch.
"""

import ctypes

import torch

from . import kernel_build
from .resid_sweep import (
    _check_theta,
    _check_v2,
    fold_combines,
    lane_major,
    live_theta_rows,
    serving_operands,
    table_lanes,
    table_operands,
    table_operators,
    theta_design,
)
from .windowed_fused import (
    PROBE_P,
    SERVING_PHASES,
    _gauss_jordan,
    _no_tf32,
    count_launch,
    split_build,
    split_combine,
)

#: Padded widths with a CLOCKED instantiation of K5's serving body (the
#: S-ROM's N=20).
SERVING_CLOCKED_NP = (24,)
#: Padded widths with a CLOCKED instantiation of K4's serving body (the
#: throughput ROM's N=15).
TABLES_CLOCKED_NP = (16,)


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
                    bdf2=True, with_trilinear=True, n_real=15,
                    lane_major=False):
    """Plain PyTorch twin of K4; same arguments and results as
    :func:`online_sweep_pallas` (the same result from either table
    layout)."""
    nt, _NP, _B = _check_v2(MN_p, KL_p, fN_p, g_p, T0_p, VE_p, b0, None,
                            with_trilinear, n_real, lane_major)
    return _sweep(table_operators(MN_p, KL_p, fN_p, lane_major), nt, g_p,
                  T0_p, VE_p, b0, dt, bdf2, with_trilinear, n_real)


def _split_sweep(operators, nt, g_p, VE_p, b0, dt, bdf2, with_trilinear,
                 n_real):
    """The split twins' step loop from a zero state: ``operators(s)``
    gives step s's (KN, bN) from (u*, combo, bdf, dtb0); then the
    reference's Gauss-Jordan over the n_real pivots and the probes."""
    NP = VE_p.shape[1]
    dtb0 = None
    if with_trilinear:
        dtb0 = torch.tensor(dt, dtype=g_p.dtype, device=g_p.device) * b0
    probes = g_p.new_empty((nt, PROBE_P, g_p.shape[2]))
    uN = g_p.new_zeros((NP, g_p.shape[2]))
    uN1 = uN
    for s in range(nt):
        if bdf2:
            bdf = 1.0 if s == 0 else 1.5
            combo = 2.0 * uN - 0.5 * uN1
            u_star = 2.0 * uN - uN1
        else:
            bdf, combo, u_star = 1.0, uN, uN
        KN, bN = operators(s, u_star, combo, bdf, dtb0)
        uN1, uN = uN, _gauss_jordan(KN, bN, n_real)
        probes[s] = VE_p @ uN + g_p[s]
    return probes, uN


def sweep_split(MN_p, KL_p, fN_p, g_p, T0_p, VE_p, b0, *, dt, bdf2=True,
                with_trilinear=True, n_real=15, lane_major=False):
    """K4 in the serving body's arithmetic
    (``csrc/global_tables_serving.cu``): per step u* and combo as the
    reference forms them, KN and bN from
    :func:`~.windowed_fused.split_combine`'s plain-f32 form on the step's
    table operators (KN = bdf·MN + KL + (T0·u*)·dt·b0, bN = MN·combo + fN:
    K4's order, which the kernel keeps), then the reference's Gauss-Jordan
    over the n_real pivots and the probes. Same arguments and results as
    :func:`online_sweep_pallas`."""
    nt, NP, _B = _check_v2(MN_p, KL_p, fN_p, g_p, T0_p, VE_p, b0, None,
                           with_trilinear, n_real, lane_major)
    if g_p.is_cuda:
        _no_tf32()
    ops = table_operators(MN_p, KL_p, fN_p, lane_major)

    def operators(s, u_star, combo, bdf, dtb0):
        return split_combine(*ops(s), T0_p, u_star, combo, bdf, dtb0, NP,
                             plain=True)

    return _split_sweep(operators, nt, g_p, VE_p, b0, dt, bdf2,
                        with_trilinear, n_real)


def theta_sweep_reference(THm, THk, THf, g_p, Bm, Bk, Bf, T0_p, VE_p, b0,
                          *, dt, bdf2=True, with_trilinear=True, n_real=15,
                          km=None, kk=None):
    """Plain PyTorch twin of K5; same arguments and results as
    :func:`online_sweep_theta_pallas` (it forms the operators over the
    padded extents: the rows past ``km``/``kk`` add exact zeros)."""
    nt, NP, B, km8, kk8, _kf8 = _check_theta(
        THm, THk, THf, g_p, Bm, Bk, Bf, T0_p, VE_p, b0, None,
        with_trilinear, n_real)
    live_theta_rows(km, kk, km8, kk8)
    if THm.is_cuda:
        _no_tf32()

    def operators(s):
        return ((Bm @ THm[s]).reshape(NP, NP, B),
                (Bk @ THk[s]).reshape(NP, NP, B), Bf @ THf[s])

    return _sweep(operators, nt, g_p, T0_p, VE_p, b0, dt, bdf2,
                  with_trilinear, n_real)


def theta_sweep_split(THm, THk, THf, g_p, Bm, Bk, Bf, T0_p, VE_p, b0, *,
                      dt, bdf2=True, with_trilinear=True, n_real=15,
                      km=None, kk=None):
    """K5 in the serving body's arithmetic (``csrc/global_serving.cu``):
    per step u* and combo as the reference forms them, KN and bN from
    :func:`~.windowed_fused.split_build`'s plain-f32 form over the fold of
    (Bm, Bk, T0) and the live θ rows ``km``/``kk`` (KN = bdf·MN + KL +
    (T0·u*)·dt·b0, bN = MN·combo + fN: the reference's order, which the
    kernel keeps), then the reference's Gauss-Jordan over the n_real
    pivots and the probes. Same arguments and results as
    :func:`online_sweep_theta_pallas`."""
    nt, NP, B, km8, kk8, kf8 = _check_theta(
        THm, THk, THf, g_p, Bm, Bk, Bf, T0_p, VE_p, b0, None,
        with_trilinear, n_real)
    km, kk = live_theta_rows(km, kk, km8, kk8)
    if THm.is_cuda:
        _no_tf32()
    Bmk = fold_combines(Bm, Bk, T0_p, with_trilinear)

    def operators(s, u_star, combo, bdf, dtb0):
        tts = torch.cat([THm[s], THk[s], THf[s]])
        return split_build(tts, Bmk, Bf, u_star, combo, bdf, dtb0, NP, km,
                           kk, km8, kk8, kf8, plain=True)

    return _split_sweep(operators, nt, g_p, VE_p, b0, dt, bdf2,
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


def _bind_tables(lib):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.romtime_global_tables_serving.argtypes = (
        [ptr] * 10 + [i32] * 7 + [ctypes.c_float, ptr])
    lib.romtime_global_tables_serving.restype = i32


def online_sweep_pallas(MN_p, KL_p, fN_p, g_p, T0_p, VE_p, b0, *, dt,
                        bdf2=True, with_trilinear=True, n_real=15,
                        lane_major=False):
    """Plain-f32 global sweep over materialized per-step operators (K4).

    MN_p, KL_p : (nt, NP, NP, B) mass and dt-scaled stiffness-side
                 operators (KL carries the identity on the padded diagonal)
    fN_p       : (nt, NP, B) dt-scaled right-hand side
    g_p        : (nt, PROBE_P, B) lifting probes
    T0_p       : (NP², NP) trilinear tensor (ignored without it)
    VE_p       : (PROBE_P, NP) probe rows;  b0 : (1, B) trilinear coefficient
    lane_major : MN_p, KL_p and fN_p are already in the serving body's
                 layout ((nt, B, NP, NP + 4) and (nt, B, NP)), as the
                 engine hands them down

    Returns (probes (nt, PROBE_P, B), uN_final (NP, B)), float32, from a
    zero state. CPU tensors run the twin; CUDA tensors launch K4 on the
    serving body (``csrc/global_tables_serving.cu``; a reference-layout
    table is converted first), counted in ``online_sweep_pallas.launches``
    and ``.serving_launches`` (the first design, on request only, in
    ``.first_design_launches``)."""
    kw = _tables_options(dt, bdf2, with_trilinear, n_real, lane_major)
    args = (MN_p, KL_p, fN_p, g_p, T0_p, VE_p, b0)
    if kernel_build.device_route(MN_p) == "cpu":
        return sweep_reference(*args, **kw)
    return _launch_tables(args, kw, "serving")


def _tables_options(dt, bdf2=True, with_trilinear=True, n_real=15,
                    lane_major=False):
    return dict(dt=dt, bdf2=bdf2, with_trilinear=with_trilinear,
                n_real=n_real, lane_major=lane_major)


def _launch_tables(args, kw, design, clocked=False):
    """Check K4's operands and launch ``design`` on CUDA tensors; returns
    (probes, uN) and, with ``clocked`` (NP in TABLES_CLOCKED_NP), the
    serving body's per-block phase clocks. The serving body takes
    :func:`~.resid_sweep.table_lanes` lanes a block."""
    (MN, KL, fN, g_p, T0_p, VE_p, b0) = args
    with_tri, lm = kw["with_trilinear"], kw["lane_major"]
    nt, NP, B = _check_v2(*args, None, with_tri, kw["n_real"], lm)
    design = theta_design(design)
    if clocked and (design != "serving" or NP not in TABLES_CLOCKED_NP):
        raise ValueError(f"K4's phase clocks exist on the serving design "
                         f"at NP in {TABLES_CLOCKED_NP} only")
    if MN.device.type != "cuda":
        raise ValueError(f"unsupported device {MN.device}: K4's kernels "
                         "take CUDA tensors")
    _no_tf32()
    flags = (int(bool(with_tri)), int(bool(kw["bdf2"])))
    outs = [(nt, PROBE_P, B), (NP, B)]
    clk = None
    if design == "first":
        if lm:
            raise ValueError("K4's first design takes the reference layout")
        if not with_tri:
            T0_p = MN.new_zeros((1,))
        out = kernel_build.launch(
            "global_sweep", _bind, "romtime_global_sweep",
            "global_sweep (K4, first design)",
            list(zip(("MN", "KL", "fN", "g", "T0", "VE", "b0"),
                     (MN, KL, fN, g_p, T0_p, VE_p, b0))),
            (nt, NP, B, kw["n_real"], *flags), kw["dt"], outs)
    else:
        if not lm:
            MN, KL, fN = lane_major(MN, KL, fN)
        T0, VE = table_operands(T0_p, VE_p, with_tri)
        tl = table_lanes(B, NP, MN.device)
        if clocked:
            clk = torch.zeros(((B + tl - 1) // tl, len(SERVING_PHASES) + 1),
                              dtype=torch.int64, device=MN.device)
        out = kernel_build.launch(
            "global_tables_serving", _bind_tables,
            "romtime_global_tables_serving", "global tables serving (K4)",
            list(zip(("MN", "KL", "fN", "g", "T0", "VE", "b0"),
                     (MN, KL, fN, g_p, T0, VE, b0))),
            (nt, NP, B, tl, kw["n_real"], *flags), kw["dt"], outs,
            extra=[clk])
    count_launch(online_sweep_pallas, design)
    return out + (clk,) if clocked else out


def _first_design_tables(*args, **kw):
    """K4's first design (``csrc/global_sweep.cu``) on the wrapper's
    arguments (reference layout): the same-run yardstick of
    ``chip_smoke.py`` and the card tests. CUDA tensors only."""
    return _launch_tables(args, _tables_options(**kw), "first")


def _tables_clocked(*args, **kw):
    """K4 on the serving body's CLOCKED instantiation (NP 16): (probes,
    uN, clocks), the clocks as K1's. CUDA tensors only."""
    return _launch_tables(args, _tables_options(**kw), "serving",
                          clocked=True)


def _bind_serving(lib):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.romtime_theta_global_serving.argtypes = (
        [ptr] * 8 + [i32] * 11 + [ctypes.c_float, ptr])
    lib.romtime_theta_global_serving.restype = i32
    lib.romtime_global_serving_tile.argtypes = [i32] * 4 + [ptr]
    lib.romtime_global_serving_tile.restype = i32


def global_serving_tile(NP, km8, kk8, kf8):
    """Launch shape of K5's serving body for NP and the θ extents:
    {"lanes", "threads", "ks", "smem_bytes"} (builds the library)."""
    lib = kernel_build.load("global_serving", _bind_serving)
    out = (ctypes.c_int * 4)()
    err = lib.romtime_global_serving_tile(NP, km8, kk8, kf8, out)
    kernel_build.check_launch(lib, err, "global_serving tile")
    return dict(zip(("lanes", "threads", "ks", "smem_bytes"), out))


def _launch_theta(args, kw, design, clocked=False):
    """Check K5's operands and launch ``design`` on CUDA tensors; returns
    (probes, uN) and, with ``clocked`` (NP in SERVING_CLOCKED_NP), the
    serving body's per-block phase clocks."""
    (THm, THk, THf, g_p, Bm, Bk, Bf, T0_p, VE_p, b0) = args
    with_tri = kw["with_trilinear"]
    nt, NP, B, km8, kk8, kf8 = _check_theta(*args, None, with_tri,
                                            kw["n_real"])
    km, kk = live_theta_rows(kw["km"], kw["kk"], km8, kk8)
    design = theta_design(design)
    if clocked and (design != "serving" or NP not in SERVING_CLOCKED_NP):
        raise ValueError(f"K5's phase clocks exist on the serving design "
                         f"at NP in {SERVING_CLOCKED_NP} only")
    if THm.device.type != "cuda":
        raise ValueError(f"unsupported device {THm.device}: K5's kernels "
                         "take CUDA tensors")
    _no_tf32()
    flags = (int(bool(with_tri)), int(bool(kw["bdf2"])))
    outs = [(nt, PROBE_P, B), (NP, B)]
    clk = None
    if design == "first":
        if not with_tri:
            T0_p = THm.new_zeros((1,))
        out = kernel_build.launch(
            "global_sweep", _bind, "romtime_theta_global_sweep",
            "theta global_sweep (K5, first design)",
            list(zip(("THm", "THk", "THf", "g", "Bm", "Bk", "Bf", "T0",
                      "VE", "b0"),
                     (THm, THk, THf, g_p, Bm, Bk, Bf, T0_p, VE_p, b0))),
            (nt, NP, B, km8, kk8, kf8, kw["n_real"], *flags), kw["dt"],
            outs)
    else:
        TH, Bmk, BfT, VE = serving_operands(THm, THk, THf, g_p, Bm, Bk, Bf,
                                            T0_p, VE_p, with_tri)
        if clocked:
            lanes = global_serving_tile(NP, km8, kk8, kf8)["lanes"]
            clk = torch.zeros(((B + lanes - 1) // lanes,
                               len(SERVING_PHASES) + 1), dtype=torch.int64,
                              device=THm.device)
        out = kernel_build.launch(
            "global_serving", _bind_serving, "romtime_theta_global_serving",
            "theta global serving (K5)",
            list(zip(("TH", "Bmk", "Bf", "VE", "b0"),
                     (TH, Bmk, BfT, VE, b0))),
            (nt, NP, B, km8, kk8, kf8, km, kk, kw["n_real"], *flags),
            kw["dt"], outs, extra=[clk])
    count_launch(online_sweep_theta_pallas, design)
    return out + (clk,) if clocked else out


def _theta_options(dt, bdf2=True, with_trilinear=True, n_real=15, km=None,
                   kk=None):
    return dict(dt=dt, bdf2=bdf2, with_trilinear=with_trilinear,
                n_real=n_real, km=km, kk=kk)


def online_sweep_theta_pallas(THm, THk, THf, g_p, Bm, Bk, Bf, T0_p, VE_p,
                              b0, *, dt, bdf2=True, with_trilinear=True,
                              n_real=15, km=None, kk=None):
    """θ-streaming global sweep (K5): as :func:`online_sweep_pallas`, with
    the step's operators formed in the kernel from

    THm, THk, THf : (nt, km8|kk8|kf8, B) θ streams (8-aligned row counts;
                    THk ends in the constant-1 row of the padded diagonal)
    Bm, Bk        : (NP², km8|kk8) combine tensors (dt folded into Bk)
    Bf            : (NP, kf8) (dt folded)
    km, kk        : live θm and θk rows
                    (:func:`~.resid_sweep.live_theta_rows`; default the
                    padded extents)

    CPU tensors run the twin; CUDA tensors launch K5 on the serving body
    (``csrc/global_serving.cu``), counted in
    ``online_sweep_theta_pallas.launches`` and ``.serving_launches`` (the
    first design, on request only, in ``.first_design_launches``)."""
    kw = _theta_options(dt, bdf2, with_trilinear, n_real, km, kk)
    args = (THm, THk, THf, g_p, Bm, Bk, Bf, T0_p, VE_p, b0)
    if kernel_build.device_route(THm) == "cpu":
        return theta_sweep_reference(*args, **kw)
    return _launch_theta(args, kw, "serving")


def _first_design_theta(*args, **kw):
    """K5's first design (``csrc/global_sweep.cu``) on the wrapper's
    arguments: the same-run yardstick of ``chip_smoke.py`` and the card
    tests. CUDA tensors only."""
    return _launch_theta(args, _theta_options(**kw), "first")


def _theta_clocked(*args, **kw):
    """K5 on the serving body's CLOCKED instantiation (NP 24): (probes,
    uN, clocks), the clocks as K1's. CUDA tensors only."""
    return _launch_theta(args, _theta_options(**kw), "serving",
                         clocked=True)


online_sweep_pallas.launches = 0
online_sweep_pallas.serving_launches = 0
online_sweep_pallas.first_design_launches = 0
online_sweep_theta_pallas.launches = 0
online_sweep_theta_pallas.serving_launches = 0
online_sweep_theta_pallas.first_design_launches = 0
