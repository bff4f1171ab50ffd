"""Residual-form per-window serving sweeps: K2 over materialized operator
tables and K3 over θ streams.

Counterparts of ``romtime_tpu/ops/pallas_online.py``
``online_sweep_pallas_v2`` (:1048, kernel ``_sweep_kernel_v2`` :962) and
``online_sweep_theta_pallas_v2`` (:1220, kernel
``_theta_sweep_kernel_v2`` :1100). This module holds

- the plain PyTorch twins :func:`sweep_v2_reference` and
  :func:`theta_sweep_v2_reference`, a lane-batched loop of torch ops over
  :func:`_bdf_step_resid` (``_bdf_step_resid`` :526, op for op);
- :func:`sweep_v2_split` and :func:`theta_sweep_v2_split`, K2 and K3 in
  the serving body's arithmetic (:func:`~.windowed_fused.split_combine`:
  the trilinear term formed once, r0 from the build's own segments);
- the wrappers :func:`online_sweep_pallas_v2` and
  :func:`online_sweep_theta_pallas_v2`, which run the twin for CPU tensors
  and a hand-written CUDA kernel for CUDA tensors: K2 on the serving body
  over its materialized tables (``csrc/resid_tables_serving.cu``) and K3
  on the serving body (``csrc/windowed_serving.cu``) for every call,
  their first designs (``csrc/resid_sweep.cu``) only on an explicit
  request (:func:`theta_design`). There is no fallback between any of
  them.

Per step, for every lane (μ) b:

    pred, d = dd BDF-2 predictor of the double-f32 carry (BDF-1 at global
              step 0)
    dtS  = KL + reshape(T0·pred)·dt·b0                (trilinear, optional)
    KN   = bdf·MN + dtS
    r0   = MN·d + fN − dtS·pred
    KN·δ = r0,  u = pred ⊕ δ                          (dd add)
    probes = VE·u + g

K2 reads MN (nt, NP, NP, B), KL and fN per step; K3 forms MN = Bm·θm,
KL = Bk·θk and fN = Bf·θf per step. K2's serving body reads its tables
lane-major, (nt, B, NP, NP + 4) and (nt, B, NP) (:func:`lane_major`): the
wrapper converts the reference layout on entry, and the engine hands
lane-major tables down directly (``lane_major=True``). The dd state ``state0`` (4, NP, B)
comes in and goes out, and ``step0`` (the launch's first global step)
only selects BDF-1 at global step 0, so per-window launches chain. The
TPU tiling (128-lane blocks, DMA chunks, the step unroll policy) is not
carried over.
"""

import ctypes

import torch

from . import kernel_build
from .compensated import dd_add_small
from .windowed_fused import (
    LU_BLOCK,
    PROBE_P,
    SERVING_CLOCKED_NP,
    SERVING_PHASES,
    _bind_serving,
    _dd_predictor,
    _no_tf32,
    _solve_step,
    count_launch,
    lanes_solve,
    pad_dim,
    pad_rows,
    serving_tile,
    split_build,
    split_combine,
)

#: The designs of K2-K5 on the card: the serving body, and the first
#: design (the same-run yardstick).
DESIGNS = ("serving", "first")
#: Lanes a block of the serving body over materialized tables (K2, K4).
TABLE_LANES = (4, 8, 16)


def lane_major(MN_p, KL_p, fN_p):
    """Reference-layout tables MN, KL (nt, NP, NP, B) and fN (nt, NP, B)
    in the serving body's lane-major layout: (nt, B, NP, NP + 4), rows
    padded with 4 zeros, and (nt, B, NP)."""
    pad = torch.nn.functional.pad
    return (pad(MN_p.permute(0, 3, 1, 2), (0, 4)).contiguous(),
            pad(KL_p.permute(0, 3, 1, 2), (0, 4)).contiguous(),
            fN_p.permute(0, 2, 1).contiguous())


def table_operators(MN_p, KL_p, fN_p, lane_major=False):
    """``operators(s)``: step s's (MN, KL, fN) as contiguous (NP, NP, B)
    and (NP, B) tensors from tables in either layout (the same values in
    the same memory order, so a twin gives the same result from both)."""
    if not lane_major:
        return lambda s: (MN_p[s], KL_p[s], fN_p[s])
    NP = fN_p.shape[2]
    return lambda s: (MN_p[s, :, :, :NP].permute(1, 2, 0).contiguous(),
                      KL_p[s, :, :, :NP].permute(1, 2, 0).contiguous(),
                      fN_p[s].T.contiguous())


def table_lanes_max(NP):
    """The largest lane tile of the materialized serving body at NP (its
    register cap): 16 lanes at NP ≤ 32, 8 at NP 40, 4 above."""
    return 16 if NP <= 32 else (8 if NP <= 40 else 4)


def pick_table_lanes(B, NP, n_sm):
    """Lanes a block for a materialized serving-body launch of B lanes on
    ``n_sm`` SMs: the fewest lanes an SM over the launch (waves of one
    block an SM × lanes a block), ties to the larger tile (fewer blocks).
    B=512 at NP 32 → 4 (128 blocks), B=2048 at NP 16 → 16."""
    def lanes_per_sm(tl):
        return -(-(-(-B // tl)) // n_sm) * tl

    return min((tl for tl in TABLE_LANES if tl <= table_lanes_max(NP)),
               key=lambda tl: (lanes_per_sm(tl), -tl))


def table_lanes(B, NP, device):
    """:func:`pick_table_lanes` on the card ``device``."""
    return pick_table_lanes(
        B, NP, torch.cuda.get_device_properties(device).multi_processor_count)


def table_operands(T0_p, VE_p, with_trilinear):
    """The materialized serving body's constants: the T0 fold
    (1, NP, NP, NP + 4) (slice k row i = T0[(i, ·), k]; a one-float
    placeholder without the trilinear term) and VE (1, PROBE_P, NP + 4),
    their rows padded (:func:`~.windowed_fused.pad_rows`)."""
    NP = VE_p.shape[-1]
    T0 = (pad_rows(T0_p.T.contiguous(), 1, NP, NP, NP) if with_trilinear
          else VE_p.new_zeros((1,)))
    return T0, pad_rows(VE_p, 1, PROBE_P, NP)


def pad_reduced_tables(MN_tab, KLIN_tab, fN_tab, N, n_pad=None):
    """(nt, N², B)/(nt, N, B) tables → padded (nt, NP, NP, B)/(nt, NP, B).

    The padded diagonal of KLIN is set to 1, so the padded block of the
    per-step system matrix is the identity."""
    NP = n_pad or pad_dim(N)
    nt, _, B = MN_tab.shape

    def pad_mat(tab, diag):
        out = tab.new_zeros((nt, NP, NP, B))
        out[:, :N, :N] = tab.reshape(nt, N, N, B)
        if diag:
            pad = torch.arange(N, NP, device=tab.device)
            out[:, pad, pad] = 1.0
        return out

    fN_p = fN_tab.new_zeros((nt, NP, B))
    fN_p[:, :N] = fN_tab
    return pad_mat(MN_tab, False), pad_mat(KLIN_tab, True), fN_p


# ======================================================================
# Plain PyTorch twins
# ======================================================================
def _bdf_step_resid(MN, KL, fN, g, uN, lo, uN1, lo1, step, T0, VE, dtb0,
                    bdf2, n_real, NP):
    """One residual-form BDF step on (NP, NP, B) operators; ``dtb0`` is
    dt·b0 (1, B), or None without the trilinear term."""
    pred_hi, pred_lo, d, bdf = _dd_predictor(uN, lo, uN1, lo1, step, bdf2)
    dtS = KL
    if dtb0 is not None:
        NN = (T0 @ pred_hi).reshape(NP, NP, -1)
        dtS = dtS + NN * dtb0
    KN = bdf * MN + dtS
    r0 = ((MN * d[None, :, :]).sum(dim=1) + fN
          - (dtS * pred_hi[None, :, :]).sum(dim=1))
    delta = lanes_solve(KN, r0, n_real, NP)
    uN_new, lo_new = dd_add_small(pred_hi, pred_lo, delta)
    probes = VE @ uN_new + g
    return uN_new, lo_new, probes


def _resid_sweep(operators, nt, g, T0, VE, b0, state0, dt, step0, bdf2,
                 with_trilinear, n_real):
    """The twins' step loop; ``operators(s)`` gives step s's (MN, KL,
    fN)."""
    NP = VE.shape[1]
    B = state0.shape[2]
    if g.is_cuda:
        _no_tf32()
    dtb0 = None
    if with_trilinear:
        dtb0 = torch.tensor(dt, dtype=g.dtype, device=g.device) * b0
    probes = g.new_empty((nt, PROBE_P, B))
    uN, lo, uN1, lo1 = state0[0], state0[1], state0[2], state0[3]
    for s in range(nt):
        MN, KL, fN = operators(s)
        uN_new, lo_new, probes[s] = _bdf_step_resid(
            MN, KL, fN, g[s], uN, lo, uN1, lo1, int(step0) + s, T0, VE,
            dtb0, bdf2, n_real, NP)
        uN1, lo1, uN, lo = uN, lo, uN_new, lo_new
    return probes, torch.stack([uN, lo, uN1, lo1])


def _check_common(nt, g, T0, VE, b0, state0, with_trilinear, n_real):
    """Shapes shared by K2-K5 (K4 and K5 carry no state: ``state0`` is
    None); returns (NP, B)."""
    NP = VE.shape[-1]
    B = g.shape[-1]
    if nt < 1:
        raise ValueError("a sweep needs at least one step")
    if VE.shape != (PROBE_P, NP) or NP % LU_BLOCK or NP > 64:
        raise ValueError(f"VE must be ({PROBE_P}, NP) with NP a multiple of "
                         f"{LU_BLOCK} and at most 64, got {tuple(VE.shape)}")
    if g.shape != (nt, PROBE_P, B):
        raise ValueError(f"g must be ({nt}, {PROBE_P}, {B})")
    if b0.shape != (1, B):
        raise ValueError("b0 must be (1, B)")
    if state0 is not None and state0.shape != (4, NP, B):
        raise ValueError("state0 must be (4, NP, B)")
    if with_trilinear and T0.shape != (NP * NP, NP):
        raise ValueError("T0 must be (NP², NP)")
    if not 1 <= n_real <= NP:
        raise ValueError(f"n_real {n_real} outside 1..{NP}")
    return NP, B


def _check_v2(MN, KL, fN, g, T0, VE, b0, state0, with_trilinear, n_real,
              lane_major=False):
    nt = MN.shape[0]
    NP, B = _check_common(nt, g, T0, VE, b0, state0, with_trilinear, n_real)
    if lane_major:
        if (MN.shape != (nt, B, NP, NP + 4) or KL.shape != MN.shape
                or fN.shape != (nt, B, NP)):
            raise ValueError("lane-major MN/KL must be (nt, B, NP, NP + 4) "
                             "and fN (nt, B, NP)")
    elif (MN.shape != (nt, NP, NP, B) or KL.shape != MN.shape
            or fN.shape != (nt, NP, B)):
        raise ValueError("MN/KL must be (nt, NP, NP, B) and fN (nt, NP, B)")
    return nt, NP, B


def _check_theta(THm, THk, THf, g, Bm, Bk, Bf, T0, VE, b0, state0,
                 with_trilinear, n_real):
    nt = THm.shape[0]
    NP, B = _check_common(nt, g, T0, VE, b0, state0, with_trilinear, n_real)
    km8, kk8, kf8 = THm.shape[1], THk.shape[1], THf.shape[1]
    for k in (km8, kk8, kf8):
        if k % 8:
            raise ValueError("θ table k dims must be 8-aligned (pad with "
                             "zero rows + zero basis columns)")
    if (THm.shape != (nt, km8, B) or THk.shape != (nt, kk8, B)
            or THf.shape != (nt, kf8, B)):
        raise ValueError("θ tables must be (nt, k8, B)")
    if (Bm.shape != (NP * NP, km8) or Bk.shape != (NP * NP, kk8)
            or Bf.shape != (NP, kf8)):
        raise ValueError("Bm/Bk must be (NP², k8) and Bf (NP, kf8)")
    return nt, NP, B, km8, kk8, kf8


def live_theta_rows(km, kk, km8, kk8):
    """(km, kk): the live θm and θk rows a serving-body launch streams
    (a padded row is an exact zero), by default the padded extents, which
    are always right. The θk rows must include the constant-1 row of the
    padded diagonal."""
    km = km8 if km is None else int(km)
    kk = kk8 if kk is None else int(kk)
    if not (1 <= km <= km8 and 1 <= kk <= kk8):
        raise ValueError(f"live θ rows km={km}, kk={kk} outside "
                         f"1..{km8}, 1..{kk8}")
    return km, kk


def fold_combines(Bm, Bk, T0, with_trilinear):
    """The folded combine [Bm | Bk | T0] (NP², kfold) of one window's
    (NP², k) combine tensors; its transpose is the layout of the windowed
    engine's ``tables["Bmk"][w]``."""
    return torch.cat([Bm, Bk] + ([T0] if with_trilinear else []), dim=1)


def serving_operands(THm, THk, THf, g, Bm, Bk, Bf, T0, VE, with_trilinear):
    """The serving body's operands from K3's or K5's: the merged θ table
    TH (nt, K8, B) = [θm | θk | θf | g], the fold (1, kfold, NP, NP + 4)
    and VE (1, PROBE_P, NP + 4) with their rows padded
    (:func:`~.windowed_fused.pad_rows`), Bf transposed (1, kf8, NP)."""
    NP = VE.shape[-1]
    Bmk = fold_combines(Bm, Bk, T0, with_trilinear).T
    return (torch.cat([THm, THk, THf, g], dim=1).contiguous(),
            pad_rows(Bmk.contiguous(), 1, Bmk.shape[0], NP, NP),
            Bf.T.contiguous()[None], pad_rows(VE, 1, PROBE_P, NP))


def theta_design(design=None):
    """The design that runs a K2-K5 call on the card: the serving body
    for every option (NP a multiple of 8 up to 64, with or without the
    trilinear term, BDF-1 or BDF-2), the first design only when
    ``design="first"`` asks for it. The route depends on the request
    only, never on a shape or a failure."""
    if design is None:
        return "serving"
    if design not in DESIGNS:
        raise ValueError(f"unknown design {design!r}; one of "
                         f"{', '.join(DESIGNS)}")
    return design


def sweep_v2_reference(MN_p, KL_p, fN_p, g_p, T0_p, VE_p, b0, state0, *,
                       dt, step0=0, bdf2=True, with_trilinear=True,
                       n_real=15, lane_major=False):
    """Plain PyTorch twin of K2; same arguments and results as
    :func:`online_sweep_pallas_v2` (the same result from either table
    layout)."""
    nt, _NP, _B = _check_v2(MN_p, KL_p, fN_p, g_p, T0_p, VE_p, b0, state0,
                            with_trilinear, n_real, lane_major)
    return _resid_sweep(table_operators(MN_p, KL_p, fN_p, lane_major), nt,
                        g_p, T0_p, VE_p, b0, state0, dt, step0, bdf2,
                        with_trilinear, n_real)


def _split_resid_sweep(operators, nt, g_p, T0_p, VE_p, b0, state0, dt,
                       step0, bdf2, with_trilinear, n_real):
    """The split twins' step loop: ``operators(s)`` gives step s's (KN,
    r0) from the predictor's (pred, d, bdf, dtb0); then the reference's
    solve, dd add and probes."""
    NP = VE_p.shape[1]
    dtb0 = None
    if with_trilinear:
        dtb0 = torch.tensor(dt, dtype=g_p.dtype, device=g_p.device) * b0
    probes = g_p.new_empty((nt, PROBE_P, g_p.shape[2]))
    uN, lo, uN1, lo1 = state0[0], state0[1], state0[2], state0[3]
    for s in range(nt):
        pred_hi, pred_lo, d, bdf = _dd_predictor(uN, lo, uN1, lo1,
                                                 int(step0) + s, bdf2)
        KN, r0 = operators(s, pred_hi, d, bdf, dtb0)
        uN_new, lo_new, probes[s], _delta, _pan = _solve_step(
            KN, r0, pred_hi, pred_lo, g_p[s], VE_p, n_real, NP, 0)
        uN1, lo1, uN, lo = uN, lo, uN_new, lo_new
    return probes, torch.stack([uN, lo, uN1, lo1])


def sweep_v2_split(MN_p, KL_p, fN_p, g_p, T0_p, VE_p, b0, state0, *, dt,
                   step0=0, bdf2=True, with_trilinear=True, n_real=15,
                   lane_major=False):
    """K2 in the serving body's arithmetic
    (``csrc/resid_tables_serving.cu``): each step's KN and r0 from
    :func:`~.windowed_fused.split_combine` on the step's table operators,
    N = T0·(dt·b0·pred) rather than the reference's (T0·pred)·dt·b0, and
    KL·pred and N·pred dotted apart rather than as dtS·pred; then the
    reference's solve, dd add and probes. Same arguments and results as
    :func:`online_sweep_pallas_v2`."""
    nt, NP, _B = _check_v2(MN_p, KL_p, fN_p, g_p, T0_p, VE_p, b0, state0,
                           with_trilinear, n_real, lane_major)
    if g_p.is_cuda:
        _no_tf32()
    ops = table_operators(MN_p, KL_p, fN_p, lane_major)

    def operators(s, pred, d, bdf, dtb0):
        return split_combine(*ops(s), T0_p, pred, d, bdf, dtb0, NP)

    return _split_resid_sweep(operators, nt, g_p, T0_p, VE_p, b0, state0,
                              dt, step0, bdf2, with_trilinear, n_real)


def theta_sweep_v2_reference(THm, THk, THf, g_p, Bm, Bk, Bf, T0_p, VE_p,
                             b0, state0, *, dt, step0=0, bdf2=True,
                             with_trilinear=True, n_real=15, km=None,
                             kk=None):
    """Plain PyTorch twin of K3; same arguments and results as
    :func:`online_sweep_theta_pallas_v2` (it forms the operators over the
    padded extents: the rows past ``km``/``kk`` add exact zeros)."""
    nt, NP, B, km8, kk8, _kf8 = _check_theta(
        THm, THk, THf, g_p, Bm, Bk, Bf, T0_p, VE_p, b0, state0,
        with_trilinear, n_real)
    live_theta_rows(km, kk, km8, kk8)
    if THm.is_cuda:
        _no_tf32()

    def operators(s):
        return ((Bm @ THm[s]).reshape(NP, NP, B),
                (Bk @ THk[s]).reshape(NP, NP, B), Bf @ THf[s])

    return _resid_sweep(operators, nt, g_p, T0_p, VE_p, b0, state0, dt,
                        step0, bdf2, with_trilinear, n_real)


def theta_sweep_v2_split(THm, THk, THf, g_p, Bm, Bk, Bf, T0_p, VE_p, b0,
                         state0, *, dt, step0=0, bdf2=True,
                         with_trilinear=True, n_real=15, km=None, kk=None):
    """K3 in the serving body's arithmetic (``csrc/windowed_serving.cu``):
    each step's KN and r0 from :func:`~.windowed_fused.split_build` over
    the fold of (Bm, Bk, T0) and the live θ rows ``km``/``kk``
    (:func:`live_theta_rows`), N = T0·(dt·b0·pred) rather than the
    reference's (T0·pred)·dt·b0, and KL·pred and N·pred dotted apart
    rather than as dtS·pred; then the reference's solve, dd add and
    probes. Same arguments and results as
    :func:`online_sweep_theta_pallas_v2`."""
    nt, NP, B, km8, kk8, kf8 = _check_theta(
        THm, THk, THf, g_p, Bm, Bk, Bf, T0_p, VE_p, b0, state0,
        with_trilinear, n_real)
    km, kk = live_theta_rows(km, kk, km8, kk8)
    if THm.is_cuda:
        _no_tf32()
    Bmk = fold_combines(Bm, Bk, T0_p, with_trilinear)

    def operators(s, pred, d, bdf, dtb0):
        tts = torch.cat([THm[s], THk[s], THf[s]])
        return split_build(tts, Bmk, Bf, pred, d, bdf, dtb0, NP, km, kk,
                           km8, kk8, kf8)

    return _split_resid_sweep(operators, nt, g_p, T0_p, VE_p, b0, state0,
                              dt, step0, bdf2, with_trilinear, n_real)


# ======================================================================
# CUDA kernels: bind, launch (built by kernel_build)
# ======================================================================
def _bind(lib):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.romtime_resid_sweep.argtypes = (
        [ptr] * 10 + [i32] * 7 + [ctypes.c_float, ptr])
    lib.romtime_resid_sweep.restype = i32
    lib.romtime_theta_resid_sweep.argtypes = (
        [ptr] * 13 + [i32] * 10 + [ctypes.c_float, ptr])
    lib.romtime_theta_resid_sweep.restype = i32


def _bind_tables(lib):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.romtime_resid_tables_serving.argtypes = (
        [ptr] * 11 + [i32] * 7 + [ctypes.c_float, ptr])
    lib.romtime_resid_tables_serving.restype = i32
    lib.romtime_resid_tables_serving_tile.argtypes = [i32] * 3 + [ptr]
    lib.romtime_resid_tables_serving_tile.restype = i32


def resid_tables_tile(NP, lanes, with_trilinear=True):
    """Launch shape of K2's serving body for NP and ``lanes`` a block:
    {"lanes", "threads", "ks", "smem_bytes", "ring_units", "lanes_max"}
    (builds the library; raises for a shape it does not take). K4's body
    (``csrc/global_tables_serving.cu``) lays out the same shapes."""
    lib = kernel_build.load("resid_tables_serving", _bind_tables)
    out = (ctypes.c_int * 6)()
    err = lib.romtime_resid_tables_serving_tile(
        NP, lanes, int(bool(with_trilinear)), out)
    kernel_build.check_launch(lib, err, "resid_tables_serving tile")
    return dict(zip(("lanes", "threads", "ks", "smem_bytes", "ring_units",
                     "lanes_max"), out))


def online_sweep_pallas_v2(MN_p, KL_p, fN_p, g_p, T0_p, VE_p, b0, state0,
                           *, dt, step0=0, bdf2=True, with_trilinear=True,
                           n_real=15, lane_major=False):
    """Residual-form sweep over materialized per-step operators (K2).

    MN_p, KL_p : (nt, NP, NP, B) mass and dt-scaled stiffness-side
                 operators (KL carries the identity on the padded diagonal)
    fN_p       : (nt, NP, B) dt-scaled right-hand side
    g_p        : (nt, PROBE_P, B) lifting probes
    T0_p       : (NP², NP) trilinear tensor (ignored without it)
    VE_p       : (PROBE_P, NP) probe rows;  b0 : (1, B) trilinear coefficient
    state0     : (4, NP, B) dd carry (uN_hi, uN_lo, uN1_hi, uN1_lo): zeros
                 for a fresh trajectory, the previous window's when chained
    step0      : global index of this launch's first step
    lane_major : MN_p, KL_p and fN_p are already in the serving body's
                 layout (:func:`lane_major`: (nt, B, NP, NP + 4) and
                 (nt, B, NP)), as the engine hands them down

    Returns (probes (nt, PROBE_P, B), state (4, NP, B)), float32. CPU
    tensors run the twin; CUDA tensors launch K2 on the serving body
    (``csrc/resid_tables_serving.cu``; a reference-layout table is
    converted first), counted in ``online_sweep_pallas_v2.launches`` and
    ``.serving_launches`` (the first design, on request only, in
    ``.first_design_launches``)."""
    kw = _v2_options(dt, step0, bdf2, with_trilinear, n_real, lane_major)
    args = (MN_p, KL_p, fN_p, g_p, T0_p, VE_p, b0, state0)
    if kernel_build.device_route(MN_p) == "cpu":
        return sweep_v2_reference(*args, **kw)
    return _launch_v2(args, kw, "serving")


def _v2_options(dt, step0=0, bdf2=True, with_trilinear=True, n_real=15,
                lane_major=False):
    return dict(dt=dt, step0=step0, bdf2=bdf2, with_trilinear=with_trilinear,
                n_real=n_real, lane_major=lane_major)


def _launch_v2(args, kw, design, clocked=False, lanes=None):
    """Check K2's operands and launch ``design`` on CUDA tensors; returns
    (probes, state) and, with ``clocked`` (the serving body's CLOCKED
    instantiation, NP in SERVING_CLOCKED_NP), its per-block phase clocks.
    ``lanes`` forces the serving body's lanes a block (default
    :func:`table_lanes`)."""
    (MN, KL, fN, g_p, T0_p, VE_p, b0, state0) = args
    with_tri, lm = kw["with_trilinear"], kw["lane_major"]
    nt, NP, B = _check_v2(*args, with_tri, kw["n_real"], lm)
    design = theta_design(design)
    if clocked and (design != "serving" or NP not in SERVING_CLOCKED_NP):
        raise ValueError(f"K2's phase clocks exist on the serving design "
                         f"at NP in {SERVING_CLOCKED_NP} only")
    if MN.device.type != "cuda":
        raise ValueError(f"unsupported device {MN.device}: K2's kernels "
                         "take CUDA tensors")
    _no_tf32()
    flags = (int(bool(with_tri)), int(bool(kw["bdf2"])))
    outs = [(nt, PROBE_P, B), (4, NP, B)]
    clk = None
    if design == "first":
        if lm or lanes is not None:
            raise ValueError("K2's first design takes the reference layout "
                             "and picks its own tile")
        if not with_tri:
            T0_p = MN.new_zeros((1,))
        out = kernel_build.launch(
            "resid_sweep", _bind, "romtime_resid_sweep",
            "resid_sweep (K2, first design)",
            list(zip(("MN", "KL", "fN", "g", "T0", "VE", "b0", "state0"),
                     (MN, KL, fN, g_p, T0_p, VE_p, b0, state0))),
            (nt, NP, B, kw["n_real"], int(kw["step0"]), *flags), kw["dt"],
            outs)
    else:
        if not lm:
            MN, KL, fN = lane_major(MN, KL, fN)
        T0, VE = table_operands(T0_p, VE_p, with_tri)
        tl = table_lanes(B, NP, MN.device) if lanes is None else int(lanes)
        if clocked:
            clk = torch.zeros(((B + tl - 1) // tl, len(SERVING_PHASES) + 1),
                              dtype=torch.int64, device=MN.device)
        out = kernel_build.launch(
            "resid_tables_serving", _bind_tables,
            "romtime_resid_tables_serving", "resid tables serving (K2)",
            list(zip(("MN", "KL", "fN", "g", "T0", "VE", "b0", "state0"),
                     (MN, KL, fN, g_p, T0, VE, b0, state0))),
            (nt, NP, B, tl, int(kw["step0"]), *flags), kw["dt"], outs,
            extra=[clk])
    count_launch(online_sweep_pallas_v2, design)
    return out + (clk,) if clocked else out


def _first_design_v2(*args, **kw):
    """K2's first design (``csrc/resid_sweep.cu``) on the wrapper's
    arguments (reference layout): the same-run yardstick of
    ``chip_smoke.py`` and the card tests. CUDA tensors only."""
    return _launch_v2(args, _v2_options(**kw), "first")


def _v2_clocked(*args, **kw):
    """K2 on the serving body's CLOCKED instantiation (NP in
    SERVING_CLOCKED_NP): (probes, state, clocks), the clocks as K1's.
    CUDA tensors only."""
    return _launch_v2(args, _v2_options(**kw), "serving", clocked=True)


def _v2_lanes(*args, lanes, **kw):
    """K2 on the serving body with ``lanes`` lanes a block (4, 8 or 16,
    at most :func:`table_lanes_max`), for measuring the tile choice.
    CUDA tensors only."""
    return _launch_v2(args, _v2_options(**kw), "serving", lanes=lanes)


def _launch_theta_v2(args, kw, design, clocked=False):
    """Check K3's operands and launch ``design`` on CUDA tensors; returns
    (probes, state) and, with ``clocked`` (the serving body's CLOCKED
    instantiation, NP in SERVING_CLOCKED_NP), its per-block phase
    clocks."""
    (THm, THk, THf, g_p, Bm, Bk, Bf, T0_p, VE_p, b0, state0) = args
    with_tri = kw["with_trilinear"]
    nt, NP, B, km8, kk8, kf8 = _check_theta(*args, with_tri, kw["n_real"])
    km, kk = live_theta_rows(kw["km"], kw["kk"], km8, kk8)
    design = theta_design(design)
    if clocked and (design != "serving" or NP not in SERVING_CLOCKED_NP):
        raise ValueError(f"K3's phase clocks exist on the serving design "
                         f"at NP in {SERVING_CLOCKED_NP} only")
    if THm.device.type != "cuda":
        raise ValueError(f"unsupported device {THm.device}: K3's kernels "
                         "take CUDA tensors")
    _no_tf32()
    flags = (int(bool(with_tri)), int(bool(kw["bdf2"])))
    outs = [(nt, PROBE_P, B), (4, NP, B)]
    clk = None
    if design == "first":
        if not with_tri:
            T0_p = THm.new_zeros((1,))
        out = kernel_build.launch(
            "resid_sweep", _bind, "romtime_theta_resid_sweep",
            "theta resid_sweep (K3, first design)",
            list(zip(("THm", "THk", "THf", "g", "Bm", "Bk", "Bf", "T0",
                      "VE", "b0", "state0"),
                     (THm, THk, THf, g_p, Bm, Bk, Bf, T0_p, VE_p, b0,
                      state0))),
            (nt, NP, B, km8, kk8, kf8, kw["n_real"], int(kw["step0"]),
             *flags), kw["dt"], outs)
    else:
        TH, Bmk, BfT, VE = serving_operands(THm, THk, THf, g_p, Bm, Bk, Bf,
                                            T0_p, VE_p, with_tri)
        if clocked:
            lanes = serving_tile(NP, km8, kk8, kf8)["lanes"]
            clk = torch.zeros(((B + lanes - 1) // lanes,
                               len(SERVING_PHASES) + 1), dtype=torch.int64,
                              device=THm.device)
        out = kernel_build.launch(
            "windowed_serving", _bind_serving, "romtime_theta_resid_serving",
            "theta resid serving (K3)",
            list(zip(("TH", "Bmk", "Bf", "VE", "b0", "state0"),
                     (TH, Bmk, BfT, VE, b0, state0))),
            (nt, NP, B, km8, kk8, kf8, km, kk, int(kw["step0"]), *flags),
            kw["dt"], outs, extra=[clk])
    count_launch(online_sweep_theta_pallas_v2, design)
    return out + (clk,) if clocked else out


def online_sweep_theta_pallas_v2(THm, THk, THf, g_p, Bm, Bk, Bf, T0_p,
                                 VE_p, b0, state0, *, dt, step0=0,
                                 bdf2=True, with_trilinear=True, n_real=15,
                                 km=None, kk=None):
    """θ-streaming residual-form sweep (K3): as
    :func:`online_sweep_pallas_v2`, with the step's operators formed in
    the kernel from

    THm, THk, THf : (nt, km8|kk8|kf8, B) θ streams (8-aligned row counts;
                    THk ends in the constant-1 row of the padded diagonal)
    Bm, Bk        : (NP², km8|kk8) per-window combine tensors (dt folded
                    into Bk);  Bf : (NP, kf8)
    km, kk        : live θm and θk rows (:func:`live_theta_rows`; default
                    the padded extents)

    CPU tensors run the twin; CUDA tensors launch K3 on the serving body
    (``csrc/windowed_serving.cu``), counted in
    ``online_sweep_theta_pallas_v2.launches`` and ``.serving_launches``
    (the first design, on request only, in ``.first_design_launches``)."""
    kw = _theta_v2_options(dt, step0, bdf2, with_trilinear, n_real, km, kk)
    args = (THm, THk, THf, g_p, Bm, Bk, Bf, T0_p, VE_p, b0, state0)
    if kernel_build.device_route(THm) == "cpu":
        return theta_sweep_v2_reference(*args, **kw)
    return _launch_theta_v2(args, kw, "serving")


def _theta_v2_options(dt, step0=0, bdf2=True, with_trilinear=True,
                      n_real=15, km=None, kk=None):
    return dict(dt=dt, step0=step0, bdf2=bdf2, with_trilinear=with_trilinear,
                n_real=n_real, km=km, kk=kk)


def _first_design_theta_v2(*args, **kw):
    """K3's first design (``csrc/resid_sweep.cu``) on the wrapper's
    arguments: the same-run yardstick of ``chip_smoke.py`` and the card
    tests. CUDA tensors only."""
    return _launch_theta_v2(args, _theta_v2_options(**kw), "first")


def _theta_v2_clocked(*args, **kw):
    """K3 on the serving body's CLOCKED instantiation (NP in
    SERVING_CLOCKED_NP): (probes, state, clocks), the clocks
    (blocks, len(SERVING_PHASES) + 1) int64 as K1's. CUDA tensors only."""
    return _launch_theta_v2(args, _theta_v2_options(**kw), "serving",
                            clocked=True)


online_sweep_pallas_v2.launches = 0
online_sweep_pallas_v2.serving_launches = 0
online_sweep_pallas_v2.first_design_launches = 0
online_sweep_theta_pallas_v2.launches = 0
online_sweep_theta_pallas_v2.serving_launches = 0
online_sweep_theta_pallas_v2.first_design_launches = 0
