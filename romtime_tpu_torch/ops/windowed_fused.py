"""Fused windowed serving sweep (kernel K1): the whole W-window BDF-2
trajectory of a μ batch in one launch.

Counterpart of ``romtime_tpu/ops/pallas_online.py``
``online_sweep_windowed_fused`` (:1610) and its Pallas kernel
``_windowed_fused_kernel`` (:1303). This module holds

- the plain PyTorch twin (:func:`windowed_fused_reference`), a lane-batched
  loop of torch ops that mirrors ``_bdf_step_merged``, ``_lanes_solve``,
  ``_lanes_solve_panels``, ``_panels_substitute``, ``_lanes_invert`` and
  ``_richardson_solve`` op for op;
- :func:`bdf_step_split`, the serving design's arithmetic in plain
  PyTorch (the trilinear term formed once; the tests run it through the
  twin's sweep loop with ``split=True``);
- the wrapper :func:`online_sweep_windowed_fused`, which runs the twin for
  CPU tensors and a hand-written CUDA kernel for CUDA tensors, routed by
  option (:func:`k1_design`): the serving design
  (``csrc/windowed_serving.cu``) for the per-step LU, the paired LU with
  ``sub1`` followers and the Richardson solve; the first design
  (``csrc/windowed_fused.cu``) for the other follower modes and the
  ablations. There is no fallback between any of them.

Per step, for every lane (μ) b:

    pred, d = dd BDF-2 predictor of the double-f32 carry (BDF-1 at step 0)
    KN  = Bmk · [bdf·θm; θk; dt·b0·pred]            (NP×NP solve matrix)
    fN  = Bf · θf
    r0  = Σ_k θm_k·(BmF_k·d) + fN − Σ_k θk_k·(BkF_k·pred) − dt·b0·TQ·vec(pred⊗pred)
    KN·δ = r0,  u = pred ⊕ δ                        (dd add)
    probes = VE·u + g

and at each window boundary the carry is re-expressed through T_w with a
double-word matvec. The solve is pivot-free (K = bdf·M + dt·S is
diagonally dominant at serving step sizes; the padded diagonal is the
identity). With paired LU (group G ≥ 2, N > 20) each schedule period
starts with two full-LU steps, then groups of G steps in which the
leader factorizes and the G−1 followers reuse its factors; a remainder
takes the per-step LU. The follower mode (:data:`PAIRED_MODES`) says how:

- ``sub1``: substitute r0 with the leader's factors, refine once against
  this step's own KN;
- ``warm1`` / ``warm2``: start from the previous step's δ, then one or two
  rounds of "residual against this KN, substitute";
- ``warmx``: start from 2·δₙ₋₁ − δₙ₋₂, then one round;
- ``inv1`` / ``inv2``: the leader inverts its KN (Gauss-Jordan) and solves
  by one matvec; its followers run 2 or 3 Richardson iterations with
  that inverse from a cold start.

With ``solve_iters`` set, the Richardson solve replaces the LU (and the
paired LU): at each window start K̄ = Bmk · [THbar_w; dt·b0·u] is built
from the window-mean θ rows ``THbar`` (bdf folded into the mass rows)
and the carry after the boundary transfer, and inverted once; each step
then runs ``solve_iters`` preconditioned iterations warm-started from the
previous step's δ. The previous δ (and δₙ₋₂ under ``warmx``) crosses
window boundaries through T_w as a plain f32 matvec.

``ablate`` (:data:`ABLATE_MODES`) takes one piece of the work out, for
the per-component cost ledger (``romtime_tpu_torch/kernel_ledger.py``);
any ablation turns the paired LU off. ``empty`` keeps the loop, the θ
reads and the probe stores only (probes = g, u ← 0.99·u + θ row 0, no K̄);
``no_dots`` replaces every per-step table product by the per-window
constants KN0 = Bmk·1 and fN0 = Bf·1 (the solve, predictor, dd add and
probes stay); ``no_solve`` takes δ = r0; ``no_boundary`` skips every
window transfer.

Table layouts are the reference's (padded NP = ``pad_dim(N)``, 8-aligned
θ row blocks ``[θm | θk…,1 | θf | g]``), because they are part of what
the serving prep produces. The TPU tiling (128-lane blocks, DMA chunks,
VMEM residency) is not carried over.
"""

import ctypes

import torch

from . import kernel_build
from .compensated import dd_add_small, dd_matvec, two_sum

PROBE_P = 8        # padded probe rows
GJ_FORI_MIN = 20   # above this N the solve is the blocked LU
LU_BLOCK = 8       # pivot block of the blocked LU
#: Paired-LU follower modes, in the kernel's numbering.
PAIRED_MODES = ("sub1", "warm1", "warm2", "warmx", "inv1", "inv2")
#: ``ablate`` values after None, in the kernel's numbering (1-4).
ABLATE_MODES = ("empty", "no_dots", "no_solve", "no_boundary")


def pad_dim(n):
    """Padded reduced dimension: the smallest multiple of 8 ≥ 16 holding
    n (the reference's table layout)."""
    return max(16, -(-n // 8) * 8)


def _no_tf32():
    # The reference contracts at Precision.HIGHEST; TF32 would keep ~3
    # decimal digits of every product.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ======================================================================
# Plain PyTorch twin
# ======================================================================
def _dd_predictor(uN, lo, uN1, lo1, step, bdf2):
    """(pred_hi, pred_lo, d, bdf): double-word BDF-2 extrapolation and
    history difference, BDF-1 at global step 0."""
    if not bdf2 or step == 0:
        return uN, lo, torch.zeros_like(uN), 1.0
    ph, pe = two_sum(2.0 * uN, -uN1)
    plo = pe + (2.0 * lo - lo1)
    ph, plo = two_sum(ph, plo)
    dh, de = two_sum(uN1, -uN)
    d = dh + (de + (lo1 - lo))
    return ph, plo, d, 1.5


def lanes_matvec(A, x):
    """(NP, NP, B) · (NP, B) lane-batched matvec."""
    return (A * x[None, :, :]).sum(dim=1)


def lanes_invert(K, NP):
    """Inverse of a (NP, NP, B) lane block: unrolled pivot-free
    Gauss-Jordan over all NP pivots of the augmented [K | I] (the padded
    diagonal is the identity, so the padded block inverts to I)."""
    eye = torch.eye(NP, dtype=K.dtype, device=K.device)[:, :, None]
    A = torch.cat([K, eye.expand(NP, NP, K.shape[2])], dim=1)
    for k in range(NP):
        inv = 1.0 / A[k, k]
        row = A[k] * inv[None, :]
        colk = A[:, k, :]
        A = A - colk[:, None, :] * row[None, :, :]
        A[k] = row
    return A[:, NP:, :]


def richardson_solve(KN, Kinv, r0, iters, delta0=None):
    """KN·δ = r0 by Richardson iteration preconditioned with K̄⁻¹: the
    warm start δ = δ₀ + K̄⁻¹(r0 − KN·δ₀) (δ = K̄⁻¹r0 cold), then
    ``iters`` − 1 refinements."""
    if delta0 is None:
        delta = lanes_matvec(Kinv, r0)
    else:
        delta = delta0 + lanes_matvec(Kinv, r0 - lanes_matvec(KN, delta0))
    for _ in range(iters - 1):
        resid = r0 - lanes_matvec(KN, delta)
        delta = delta + lanes_matvec(Kinv, resid)
    return delta


def window_mean_theta(TH, W, km8, kk8, bdf2):
    """THbar (W, km8 + kk8, B): the per-window mean of the θm and θk rows
    of the merged table, bdf (1.5 for BDF-2) folded into the mass rows,
    as the reference's wrapper builds it outside its kernel."""
    nt, K8, B = TH.shape
    kmk8 = km8 + kk8
    THbar = TH.reshape(W, nt // W, K8, B)[:, :, :kmk8, :].mean(dim=1)
    scale = torch.ones((kmk8, 1), dtype=TH.dtype, device=TH.device)
    scale[:km8] = 1.5 if bdf2 else 1.0
    return (THbar * scale[None]).contiguous()


def _gauss_jordan(KN, r0, n_real):
    """Unrolled pivot-free Gauss-Jordan over the first n_real pivots."""
    for k in range(n_real):
        inv = 1.0 / KN[k, k]
        row = KN[k] * inv[None, :]
        bk = r0[k] * inv
        colk = KN[:, k, :]
        KN = KN - colk[:, None, :] * row[None, :, :]
        KN[k] = row
        r0 = r0 - colk * bk[None, :]
        r0[k] = bk
    return r0


def _solve_blk_aug(D, rj):
    """Jordan on the augmented block [D | I | r] → (D⁻¹, D⁻¹r)."""
    BS = LU_BLOCK
    eye = torch.eye(BS, dtype=D.dtype, device=D.device)[:, :, None]
    A8 = torch.cat([D, eye.expand(BS, BS, D.shape[2]), rj[:, None, :]],
                   dim=1)
    for i in range(BS):
        inv = 1.0 / A8[i, i]
        rowi = A8[i] * inv[None, :]
        coli = A8[:, i, :]
        A8 = A8 - coli[:, None, :] * rowi[None, :, :]
        A8[i] = rowi
    return A8[:, BS:2 * BS], A8[:, 2 * BS]


def _matbvec(Dinv, v):
    return (Dinv * v[None, :, :]).sum(dim=1)


def _back_substitute(ys, panels):
    xs = [ys[-1]]
    for jb in range(len(panels) - 2, -1, -1):
        Dinv, U, _C = panels[jb]
        xt = torch.cat(xs, dim=0)
        Ux = (U * xt[None, :, :]).sum(dim=1)
        xs.insert(0, ys[jb] - _matbvec(Dinv, Ux))
    return torch.cat(xs, dim=0)


def lanes_solve_panels(KN, r0, NP):
    """Blocked pivot-free LU of a (NP, NP, B) lane block; returns the
    solution and the per-block panels (D⁻¹, U, C) of the partially
    eliminated matrix (the block-LU factors)."""
    BS = LU_BLOCK
    NB = NP // BS
    A, r = KN, r0
    ys, panels = [], []
    for _jb in range(NB):
        D, U, C = A[:BS, :BS], A[:BS, BS:], A[BS:, :BS]
        Dinv, y = _solve_blk_aug(D, r[:BS])
        panels.append((Dinv, U, C))
        ys.append(y)
        if A.shape[0] == BS:
            break
        CD = C[:, 0:1, :] * Dinv[0][None, :, :]
        for k in range(1, BS):
            CD = CD + C[:, k:k + 1, :] * Dinv[k][None, :, :]
        upd = CD[:, 0:1, :] * U[0][None, :, :]
        updr = C[:, 0, :] * y[0][None, :]
        for i in range(1, BS):
            upd = upd + CD[:, i:i + 1, :] * U[i][None, :, :]
            updr = updr + C[:, i, :] * y[i][None, :]
        A = A[BS:, BS:] - upd
        r = r[BS:] - updr
    return _back_substitute(ys, panels), panels


def lanes_solve(KN, r0, n_real, NP):
    """KN·δ = r0 on a (NP, NP, B) block: Gauss-Jordan for small N, the
    blocked pivot-free LU above GJ_FORI_MIN."""
    if n_real <= GJ_FORI_MIN:
        return _gauss_jordan(KN, r0, n_real)
    return lanes_solve_panels(KN, r0, NP)[0]


def panels_substitute(panels, r, NP):
    """Solve with saved block-LU panels: forward block sweep + back
    substitution."""
    BS = LU_BLOCK
    ys = []
    for Dinv, _U, C in panels:
        y = _matbvec(Dinv, r[:BS])
        ys.append(y)
        if r.shape[0] > BS:
            updr = C[:, 0, :] * y[0][None, :]
            for i in range(1, BS):
                updr = updr + C[:, i, :] * y[i][None, :]
            r = r[BS:] - updr
    return _back_substitute(ys, panels)


def _follower_solve(KN, panels, r0, NP, mode, dprev, dprev2):
    """A paired-LU follower's solve with its leader's ``panels`` (the LU
    panels, or K⁻¹ under ``inv1``/``inv2``), as ``_bdf_step_merged``
    solves it (:928-945)."""
    if mode in ("inv1", "inv2"):
        return richardson_solve(KN, panels, r0, 2 if mode == "inv1" else 3)
    if mode == "sub1":
        delta = panels_substitute(panels, r0, NP)
        rounds = 1
    elif mode == "warmx":
        delta = 2.0 * dprev - dprev2
        rounds = 1
    else:
        delta = dprev
        rounds = 1 if mode == "warm1" else 2
    for _ in range(rounds):
        resid = r0 - lanes_matvec(KN, delta)
        delta = delta + panels_substitute(panels, resid, NP)
    return delta


def _bdf_step_merged(tts, Bmk, BmF, BkF, Bf, uN, lo, uN1, lo1, step, TQ,
                     VE, dtb0, bdf2, n_real, NP, km8, kk8, kf8, **solve):
    """One merged-dot residual-form BDF step (``_bdf_step_merged``).
    Returns (u_hi, u_lo, probes, δ, panels)."""
    kmk8 = km8 + kk8
    B = tts.shape[1]
    pred_hi, pred_lo, d, bdf = _dd_predictor(uN, lo, uN1, lo1, step, bdf2)

    scale = torch.ones((kmk8, 1), dtype=tts.dtype, device=tts.device)
    scale[:km8] = bdf
    rhs = tts[0:kmk8] * scale
    fN = Bf @ tts[kmk8:kmk8 + kf8]
    if dtb0 is not None:
        rhs = torch.cat([rhs, pred_hi * dtb0], dim=0)
        KN = (Bmk @ rhs).reshape(NP, NP, B)
        outer = (pred_hi[:, None, :] * pred_hi[None, :, :]).reshape(NP * NP,
                                                                   B)
        trip = (TQ @ outer) * dtb0
    else:
        KN = (Bmk @ rhs).reshape(NP, NP, B)
        trip = torch.zeros_like(pred_hi)

    km = BmF.shape[0] // NP
    kk = BkF.shape[0] // NP
    t1m = (BmF @ d).reshape(km, NP, B)
    MNd = (t1m * tts[0:km][:, None, :]).sum(dim=0)
    t1k = (BkF @ pred_hi).reshape(kk, NP, B)
    KLp = (t1k * tts[km8:km8 + kk][:, None, :]).sum(dim=0)
    r0 = MNd + fN - KLp - trip
    return _solve_step(KN, r0, pred_hi, pred_lo, tts, VE, n_real, NP,
                       kmk8 + kf8, **solve)


def split_build(tts, Bmk, Bf, pred, d, bdf, dtb0, NP, km, kk, km8, kk8,
                kf8, plain=False):
    """(KN, r0) of the serving body's segmented build
    (``csrc/serving_body.cuh``) from one step's merged θ rows ``tts``
    (K8, B) and the folded combine ``Bmk`` (NP², kfold): the live columns
    in three segments, MN = Bm·θm (unscaled, the km live θm rows),
    KL = Bk·θk (kk rows) and N = T0·(dtb0·pred) (``dtb0`` None: no
    trilinear term); then KN = bdf·MN + KL + N and
    r0 = MN·d + fN − KL·pred − N·pred, each term formed on its own and
    combined in the reference's order. ``plain`` (K5's plain-f32 step,
    ``pred`` = u* and ``d`` = combo) forms KN = bdf·MN + KL + N·dtb0 with
    N = T0·pred, K5's order, and r0 = MN·d + fN only."""
    kmk8 = km8 + kk8
    B = tts.shape[1]
    MN = (Bmk[:, :km] @ tts[:km]).reshape(NP, NP, B)
    KL = (Bmk[:, km8:km8 + kk] @ tts[km8:km8 + kk]).reshape(NP, NP, B)
    return split_combine(MN, KL, Bf @ tts[kmk8:kmk8 + kf8],
                         Bmk[:, kmk8:kmk8 + NP], pred, d, bdf, dtb0, NP,
                         plain)


def split_combine(MN, KL, fN, T0, pred, d, bdf, dtb0, NP, plain=False):
    """(KN, r0) of the serving body from one step's operators MN, KL
    (NP, NP, B) and fN (NP, B), however they were formed (K1, K3 and K5
    from θ by :func:`split_build`; K2 and K4 read from the materialized
    tables), with the trilinear T0 (NP², NP) as the body's third segment:
    KN = bdf·MN + KL + N, N = T0·(dtb0·pred) and
    r0 = MN·d + fN − KL·pred − N·pred, each term formed on its own and
    combined in the reference's order; ``plain`` as for
    :func:`split_build`."""
    B = MN.shape[2]
    KN = bdf * MN + KL
    r0 = lanes_matvec(MN, d) + fN
    if dtb0 is not None:
        # K4 and K5 scale N = T0·pred after the product, K1-K3 before it.
        Nt = (T0 @ (pred if plain else pred * dtb0)).reshape(NP, NP, B)
        KN = KN + (Nt * dtb0 if plain else Nt)
    if not plain:
        r0 = r0 - lanes_matvec(KL, pred)
        if dtb0 is not None:
            r0 = r0 - lanes_matvec(Nt, pred)
    return KN, r0


def bdf_step_split(tts, Bmk, BmF, BkF, Bf, uN, lo, uN1, lo1, step, TQ,
                   VE, dtb0, bdf2, n_real, NP, km8, kk8, kf8, **solve):
    """The BDF step of :func:`_bdf_step_merged` with the trilinear term
    formed once, as K1's serving design (``csrc/windowed_serving.cu``)
    computes it: :func:`split_build`, then the step's solve. TQ and the
    factored BmF/BkF are not read (their shapes give the live θ rows km
    and kk). Same arguments and results as :func:`_bdf_step_merged`."""
    pred_hi, pred_lo, d, bdf = _dd_predictor(uN, lo, uN1, lo1, step, bdf2)
    KN, r0 = split_build(tts, Bmk, Bf, pred_hi, d, bdf, dtb0, NP,
                         BmF.shape[0] // NP, BkF.shape[0] // NP, km8, kk8,
                         kf8)
    return _solve_step(KN, r0, pred_hi, pred_lo, tts, VE, n_real, NP,
                       km8 + kk8 + kf8, **solve)


def _solve_step(KN, r0, pred_hi, pred_lo, tts, VE, n_real, NP, off_g,
                panels=None, save_panels=False, Kinv=None, solve_iters=None,
                dprev=None, paired_mode="sub1", dprev2=None,
                skip_solve=False):
    """KN·δ = r0 by the step's solve, u = pred ⊕ δ and the probes: the
    tail of ``_bdf_step_merged``. Returns (u_hi, u_lo, probes, δ,
    panels)."""
    out_panels = None
    if skip_solve:
        delta = r0
    elif solve_iters is not None and Kinv is not None:
        delta = richardson_solve(KN, Kinv, r0, solve_iters, delta0=dprev)
    elif panels is not None:
        delta = _follower_solve(KN, panels, r0, NP, paired_mode, dprev,
                                dprev2)
    elif save_panels and paired_mode in ("inv1", "inv2"):
        out_panels = lanes_invert(KN, NP)
        delta = lanes_matvec(out_panels, r0)
    elif save_panels:
        delta, out_panels = lanes_solve_panels(KN, r0, NP)
    else:
        delta = lanes_solve(KN, r0, n_real, NP)
    uN_new, lo_new = dd_add_small(pred_hi, pred_lo, delta)
    probes = VE @ uN_new + tts[off_g:off_g + PROBE_P]
    return uN_new, lo_new, probes, delta, out_panels


def step_roles(period, group):
    """Solve role of each step of a schedule period: "full" (per-step
    LU), "lead" (factorize, keep panels) or "follow" (reuse the lead's
    panels + one refinement). Two full steps open every period (the
    BDF-1→2 switch perturbs a stale factor too much), then groups of
    ``group``, then a per-step remainder."""
    if not group:
        return ["full"] * period
    lead = min(2, period)
    n_groups = (period - lead) // group
    roles = ["full"] * lead
    for _ in range(n_groups):
        roles += ["lead"] + ["follow"] * (group - 1)
    return roles + ["full"] * (period - len(roles))


def _check_args(TH, Bmk, BmF, BkF, Bf, TQ, VE, Tp, b0, state0, widths,
                with_trilinear, km8, kk8, kf8, paired_lu, paired_mode,
                period, n_real, solve_iters, ablate):
    """Validate shapes/options; returns (W, width, NP, km, kk, period,
    group). The group is 0 (per-step solves) at N ≤ GJ_FORI_MIN, where
    the reference's Gauss-Jordan ignores paired LU, under the Richardson
    solve, which takes precedence over it, and under any ablation."""
    W = Bmk.shape[0]
    NP = VE.shape[2]
    nt, K8, B = TH.shape
    if len(set(widths)) != 1 or len(widths) != W or W * widths[0] != nt:
        raise ValueError("fused windowed sweep needs W equal window widths "
                         "covering the time grid")
    width = int(widths[0])
    if K8 != km8 + kk8 + kf8 + PROBE_P:
        raise ValueError("merged θ table rows do not match k offsets")
    for k in (km8, kk8, kf8):
        if k % 8:
            raise ValueError("θ table k dims must be 8-aligned")
    if NP % LU_BLOCK or NP > 64:
        raise ValueError(f"padded dimension {NP} must be a multiple of 8 "
                         "and at most 64")
    kfold = km8 + kk8 + (NP if with_trilinear else 0)
    km = BmF.shape[2] // NP
    kk = BkF.shape[2] // NP
    if (Bmk.shape[1:] != (kfold, NP * NP) or not 1 <= km <= km8
            or not 1 <= kk <= kk8 or BmF.shape != (W, NP, km * NP)
            or BkF.shape != (W, NP, kk * NP) or Bf.shape != (W, kf8, NP)):
        raise ValueError("merged/factored combine tensor shapes do not "
                         "match the k offsets")
    if VE.shape != (W, PROBE_P, NP) or Tp.shape != (W, NP, NP):
        raise ValueError("probe rows / transfers do not match (W, NP)")
    if with_trilinear and TQ.shape != (W, NP, NP * NP):
        raise ValueError("TQ must be (W, NP, NP²)")
    if b0.shape != (1, B) or state0.shape != (4, NP, B):
        raise ValueError("b0 must be (1, B) and state0 (4, NP, B)")
    if paired_mode not in PAIRED_MODES:
        raise ValueError(f"unknown paired-LU mode {paired_mode!r}; the "
                         f"modes are {', '.join(PAIRED_MODES)}")
    if ablate is not None and ablate not in ABLATE_MODES:
        raise ValueError(f"unknown ablate {ablate!r}; None or one of "
                         f"{', '.join(ABLATE_MODES)}")
    if paired_lu is not None and paired_lu < 0:
        raise ValueError("paired_lu must be None, 0 or a group size ≥ 2")
    if solve_iters is not None and int(solve_iters) < 1:
        raise ValueError("solve_iters must be None (LU) or ≥ 1")
    period = width if period is None else int(period)
    if period < 1 or width % period:
        raise ValueError(f"period {period} must divide the window width "
                         f"{width}")
    group = paired_lu if (paired_lu and paired_lu >= 2) else 0
    if (n_real <= GJ_FORI_MIN or solve_iters is not None
            or ablate is not None):
        group = 0
    return W, width, NP, km, kk, period, group


def windowed_fused_reference(TH, Bmk, BmF, BkF, Bf, TQ, VE, Tp, b0, state0,
                             *, widths, dt, bdf2=True, with_trilinear=True,
                             n_real, km8, kk8, kf8, paired_lu=None,
                             paired_mode="sub1", period=None,
                             solve_iters=None, ablate=None, split=False):
    """Plain PyTorch twin of K1; same arguments and results as
    :func:`online_sweep_windowed_fused`. ``split`` steps with
    :func:`bdf_step_split` (the serving design's arithmetic) instead of
    the reference's ``_bdf_step_merged``."""
    W, width, NP, _km, _kk, period, group = _check_args(
        TH, Bmk, BmF, BkF, Bf, TQ, VE, Tp, b0, state0, widths,
        with_trilinear, km8, kk8, kf8, paired_lu, paired_mode, period,
        n_real, solve_iters, ablate)
    if TH.is_cuda:
        _no_tf32()
    nt, _K8, B = TH.shape
    kmk8 = km8 + kk8
    off_g = kmk8 + kf8
    dt_c = torch.tensor(dt, dtype=TH.dtype, device=TH.device)
    dtb0 = dt_c * b0 if with_trilinear else None
    roles = step_roles(period, group)
    step_fn = bdf_step_split if split else _bdf_step_merged
    THbar = (window_mean_theta(TH, W, km8, kk8, bdf2)
             if solve_iters is not None else None)
    # δ crosses window boundaries where a later step starts from it.
    carry_delta = solve_iters is not None or (
        group and paired_mode in ("warm1", "warm2", "warmx"))

    probes = TH.new_empty((nt, PROBE_P, B))
    uN, lo, uN1, lo1 = state0[0], state0[1], state0[2], state0[3]
    dprev = torch.zeros_like(uN)
    dprev2 = (torch.zeros_like(uN) if group and paired_mode == "warmx"
              else None)
    for w in range(W):
        T = Tp[w]
        if ablate != "no_boundary":
            uN, lo = dd_matvec(T, uN, lo)
            uN1, lo1 = dd_matvec(T, uN1, lo1)
            if carry_delta:
                dprev = T @ dprev
                if dprev2 is not None:
                    dprev2 = T @ dprev2
        consts = (Bmk[w].T, BmF[w].T, BkF[w].T, Bf[w].T)
        TQ_w = TQ[w] if with_trilinear else None
        VE_w = VE[w]
        Kinv = None
        if solve_iters is not None and ablate != "empty":
            thb = THbar[w]
            if with_trilinear:
                thb = torch.cat([thb, uN * dtb0], dim=0)
            Kinv = lanes_invert((consts[0] @ thb).reshape(NP, NP, B), NP)
        if ablate == "no_dots":
            KN0 = (consts[0] @ TH.new_ones((Bmk.shape[1], B))).reshape(
                NP, NP, B)
            fN0 = consts[3] @ TH.new_ones((kf8, B))
        pan = None
        for s in range(width):
            step = w * width + s
            tts = TH[step]
            g = tts[off_g:off_g + PROBE_P]
            if ablate == "empty":
                probes[step] = g
                uN1, uN = uN, uN * 0.99 + tts[0][None, :]
                continue
            if ablate == "no_dots":
                pred_hi, pred_lo, _d, _bdf = _dd_predictor(
                    uN, lo, uN1, lo1, step, bdf2)
                if solve_iters is not None:
                    delta = richardson_solve(KN0, Kinv, fN0, solve_iters,
                                             delta0=dprev)
                else:
                    delta = lanes_solve(KN0, fN0, n_real, NP)
                uN_new, lo_new = dd_add_small(pred_hi, pred_lo, delta)
                probes[step] = VE_w @ uN_new + g
                dprev = delta
                uN1, lo1, uN, lo = uN, lo, uN_new, lo_new
                continue
            role = roles[s % period]
            uN_new, lo_new, probes[step], delta, out_pan = step_fn(
                tts, *consts, uN, lo, uN1, lo1, step, TQ_w, VE_w,
                dtb0, bdf2, n_real, NP, km8, kk8, kf8,
                panels=pan if role == "follow" else None,
                save_panels=role == "lead", Kinv=Kinv,
                solve_iters=solve_iters, dprev=dprev,
                paired_mode=paired_mode, dprev2=dprev2,
                skip_solve=ablate == "no_solve",
            )
            if role == "lead":
                pan = out_pan
            if dprev2 is not None:
                dprev2 = dprev
            dprev = delta
            uN1, lo1, uN, lo = uN, lo, uN_new, lo_new
    return probes, torch.stack([uN, lo, uN1, lo1])


# ======================================================================
# CUDA kernels: bind, route, launch (built by kernel_build)
# ======================================================================
#: Phase clocks of the serving design's CLOCKED instantiation, in the
#: order of its int64 output row (then the block's total).
SERVING_PHASES = ("boundary", "wait", "build", "r0", "solve", "kbar",
                  "update")
#: Padded widths with a CLOCKED instantiation (the fleet's 50x32 and
#: 150x48 shapes).
SERVING_CLOCKED_NP = (32, 48)
_ARG_NAMES = ("TH", "Bmk", "BmF", "BkF", "Bf", "TQ", "VE", "Tp", "b0",
              "state0")


def _bind(lib):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.romtime_windowed_fused.argtypes = (
        [ptr] * 13 + [i32] * 16 + [ctypes.c_float, ptr])
    lib.romtime_windowed_fused.restype = i32


def _bind_serving(lib):
    """Every entry of ``csrc/windowed_serving.cu``: K1's serving design,
    K3 on the serving body (``ops/resid_sweep.py``) and the tile query."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.romtime_windowed_serving.argtypes = (
        [ptr] * 11 + [i32] * 14 + [ctypes.c_float, ptr])
    lib.romtime_windowed_serving.restype = i32
    lib.romtime_theta_resid_serving.argtypes = (
        [ptr] * 9 + [i32] * 11 + [ctypes.c_float, ptr])
    lib.romtime_theta_resid_serving.restype = i32
    lib.romtime_windowed_serving_tile.argtypes = [i32] * 4 + [ptr]
    lib.romtime_windowed_serving_tile.restype = i32


def k1_design(group, paired_mode, ablate):
    """The K1 design that runs these options on the card, with ``group``
    the effective paired-LU group (0 where :func:`_check_args` turns
    pairing off): ``"serving"`` (``csrc/windowed_serving.cu``) without an
    ablation and with no paired group or ``sub1`` followers, under the LU
    or the Richardson solve; ``"first"`` (``csrc/windowed_fused.cu``) for
    the other follower modes and every ablation. The route depends on the
    options only, never on a failure."""
    if ablate is None and (not group or paired_mode == "sub1"):
        return "serving"
    return "first"


def serving_tile(NP, km8, kk8, kf8):
    """Launch shape of the serving design for NP and the θ extents:
    {"lanes", "threads", "ks", "smem_bytes"} (builds the library)."""
    lib = kernel_build.load("windowed_serving", _bind_serving)
    out = (ctypes.c_int * 4)()
    err = lib.romtime_windowed_serving_tile(NP, km8, kk8, kf8, out)
    kernel_build.check_launch(lib, err, "windowed_serving tile")
    return dict(zip(("lanes", "threads", "ks", "smem_bytes"), out))


def pad_rows(t, *shape):
    """``t`` viewed as ``shape`` with its last axis padded by 4 zero
    floats: the serving body's row layout (a chunk of rows is one
    contiguous bulk copy that lands in its conflict-free shared layout)."""
    return torch.nn.functional.pad(t.view(*shape), (0, 4)).contiguous()


def count_launch(wrapper, design):
    """One launch of ``design`` in a wrapper's counters: ``.launches`` and
    ``.serving_launches`` or ``.first_design_launches``."""
    wrapper.launches += 1
    if design == "serving":
        wrapper.serving_launches += 1
    else:
        wrapper.first_design_launches += 1


def _count(design, kw):
    count_launch(online_sweep_windowed_fused, design)
    if kw["solve_iters"] is not None:
        online_sweep_windowed_fused.richardson_launches += 1


def _launch(args, kw, design=None, clocked=False):
    """Check the options and the operands and launch K1's ``design``
    (default: the one :func:`k1_design` names) on CUDA tensors; returns
    (probes, state) and, with ``clocked``, the serving design's per-block
    phase clocks."""
    (TH, Bmk, BmF, BkF, Bf, TQ, VE, Tp, b0, state0) = args
    W, width, NP, km, kk, period, group = _check_args(
        *args, kw["widths"], kw["with_trilinear"], kw["km8"], kw["kk8"],
        kw["kf8"], kw["paired_lu"], kw["paired_mode"], kw["period"],
        kw["n_real"], kw["solve_iters"], kw["ablate"])
    design = design or k1_design(group, kw["paired_mode"], kw["ablate"])
    if clocked and design != "serving":
        raise ValueError("the phase clocks exist on the serving options "
                         "only")
    if clocked and NP not in SERVING_CLOCKED_NP:
        raise ValueError(f"the phase clocks exist at NP in "
                         f"{SERVING_CLOCKED_NP} only")
    if TH.device.type != "cuda":
        raise ValueError(f"unsupported device {TH.device}")
    km8, kk8, kf8 = kw["km8"], kw["kk8"], kw["kf8"]
    if not kw["with_trilinear"]:
        TQ = TH.new_zeros((1,))
    THbar = (window_mean_theta(TH, W, km8, kk8, kw["bdf2"])
             if kw["solve_iters"] is not None else TH.new_zeros((1,)))
    for name, t in zip(_ARG_NAMES + ("THbar",),
                       args[:5] + (TQ,) + args[6:] + (THbar,)):
        if t.dtype != torch.float32 or t.device != TH.device:
            raise ValueError(f"{name} must be float32 on {TH.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    _no_tf32()
    nt, _K8, B = TH.shape
    dev = TH.device
    probes = torch.empty((nt, PROBE_P, B), dtype=torch.float32, device=dev)
    state = torch.empty((4, NP, B), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    flags = (int(bool(kw["with_trilinear"])), int(bool(kw["bdf2"])), group)
    iters = int(kw["solve_iters"] or 0)
    clk = None
    with torch.cuda.device(dev):
        if design == "serving":
            lib = kernel_build.load("windowed_serving", _bind_serving)
            Bmk = pad_rows(Bmk, W, Bmk.shape[1], NP, NP)
            Tp = pad_rows(Tp, W, NP, NP)
            VE = pad_rows(VE, W, PROBE_P, NP)
            if clocked:
                lanes = serving_tile(NP, km8, kk8, kf8)["lanes"]
                clk = torch.zeros(((B + lanes - 1) // lanes,
                                   len(SERVING_PHASES) + 1),
                                  dtype=torch.int64, device=dev)
            err = lib.romtime_windowed_serving(
                TH.data_ptr(), Bmk.data_ptr(), Bf.data_ptr(), VE.data_ptr(),
                Tp.data_ptr(), b0.data_ptr(), state0.data_ptr(),
                THbar.data_ptr(), probes.data_ptr(), state.data_ptr(),
                None if clk is None else clk.data_ptr(),
                W, width, period, NP, B, km8, kk8, kf8, km, kk, *flags,
                iters, float(kw["dt"]), stream)
        else:
            lib = kernel_build.load("windowed_fused", _bind)
            ablate = kw["ablate"]
            err = lib.romtime_windowed_fused(
                TH.data_ptr(), Bmk.data_ptr(), BmF.data_ptr(),
                BkF.data_ptr(), Bf.data_ptr(), TQ.data_ptr(), VE.data_ptr(),
                Tp.data_ptr(), b0.data_ptr(), state0.data_ptr(),
                THbar.data_ptr(), probes.data_ptr(), state.data_ptr(),
                W, width, period, NP, B, km8, kk8, kf8, km, kk, *flags,
                PAIRED_MODES.index(kw["paired_mode"]), iters,
                0 if ablate is None else 1 + ABLATE_MODES.index(ablate),
                float(kw["dt"]), stream)
    kernel_build.check_launch(lib, err, f"windowed_{design}")
    _count(design, kw)
    if clocked:
        return probes, state, clk
    return probes, state


def _options(widths, dt, bdf2, with_trilinear, n_real, km8, kk8, kf8,
             paired_lu, paired_mode, period, solve_iters, ablate):
    return dict(widths=widths, dt=dt, bdf2=bdf2,
                with_trilinear=with_trilinear, n_real=n_real, km8=km8,
                kk8=kk8, kf8=kf8, paired_lu=paired_lu,
                paired_mode=paired_mode, period=period,
                solve_iters=solve_iters, ablate=ablate)


def online_sweep_windowed_fused(TH, Bmk, BmF, BkF, Bf, TQ, VE, Tp, b0,
                                state0, *, widths, dt, bdf2=True,
                                with_trilinear=True, n_real, km8, kk8, kf8,
                                paired_lu=None, paired_mode="sub1",
                                period=None, solve_iters=None, ablate=None):
    """Whole-trajectory windowed serving sweep (K1).

    TH     : (nt, K8, B) merged θ table [θm | θk…,1 | θf | g] (8-aligned
             row blocks km8, kk8, kf8, PROBE_P)
    Bmk    : (W, kfold, NP²) transposed folded combine [Bm | Bk | T0]
             (kfold = km8 + kk8 [+ NP with the trilinear])
    BmF    : (W, NP, km·NP) transposed factored mass tensors
    BkF    : (W, NP, kk·NP) transposed factored stiffness tensors
    Bf     : (W, kf8, NP) transposed rhs combine (dt folded)
    TQ     : (W, NP, NP²) quadratic-form trilinear (ignored without it)
    VE     : (W, PROBE_P, NP) probe rows;  Tp : (W, NP, NP), Tp[0] = I
    b0     : (1, B) trilinear coefficient;  state0 : (4, NP, B) dd carry
    widths : W equal window step counts
    paired_lu : paired-LU group G ≥ 2 (None or 0: the per-step LU)
    paired_mode : follower mode, one of :data:`PAIRED_MODES`
    period : steps per grouping period (default: one window)
    solve_iters : Richardson iterations per step (None: the LU schedule)
    ablate : None, or one of :data:`ABLATE_MODES` (the cost ledger)

    Returns (probes (nt, PROBE_P, B), state (4, NP, B)), float32. CPU
    tensors run the twin; CUDA tensors launch the design that
    :func:`k1_design` names for the options: the serving design
    (``csrc/windowed_serving.cu``, which reads neither TQ nor BmF/BkF
    beyond their shapes) or the first design (``csrc/windowed_fused.cu``).
    A launch counts in ``online_sweep_windowed_fused.launches`` and in its
    design's ``.serving_launches`` or ``.first_design_launches``; one
    with the Richardson solve also in ``.richardson_launches``."""
    args = (TH, Bmk, BmF, BkF, Bf, TQ, VE, Tp, b0, state0)
    kw = _options(widths, dt, bdf2, with_trilinear, n_real, km8, kk8, kf8,
                  paired_lu, paired_mode, period, solve_iters, ablate)
    if TH.device.type == "cpu":
        return windowed_fused_reference(*args, **kw)
    return _launch(args, kw)


online_sweep_windowed_fused.launches = 0
online_sweep_windowed_fused.serving_launches = 0
online_sweep_windowed_fused.first_design_launches = 0
online_sweep_windowed_fused.richardson_launches = 0


def _full_options(kw):
    return _options(**dict(dict(bdf2=True, with_trilinear=True,
                                paired_lu=None, paired_mode="sub1",
                                period=None, solve_iters=None, ablate=None),
                           **kw))


def _first_design_sweep(*args, **kw):
    """K1's first design (``csrc/windowed_fused.cu``) on any options, the
    serving ones included: the same-run yardstick of ``chip_smoke.py``,
    the cost ledger and the card tests. CUDA tensors only."""
    return _launch(args, _full_options(kw), design="first")


def _serving_sweep_clocked(*args, **kw):
    """The serving design's CLOCKED instantiation on serving options at
    an NP of :data:`SERVING_CLOCKED_NP`: (probes, state, clocks), the
    clocks (blocks, len(SERVING_PHASES) + 1) int64 — each block's clock()
    cycles per phase of :data:`SERVING_PHASES`, then its total. CUDA
    tensors only."""
    return _launch(args, _full_options(kw), clocked=True)
