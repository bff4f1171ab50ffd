"""Fused windowed serving sweep (kernel K1): the whole W-window BDF-2
trajectory of a μ batch in one launch.

Counterpart of ``romtime_tpu/ops/pallas_online.py``
``online_sweep_windowed_fused`` (:1610) and its Pallas kernel
``_windowed_fused_kernel`` (:1303). This module holds

- the plain PyTorch twin (:func:`windowed_fused_reference`), a lane-batched
  loop of torch ops that mirrors ``_bdf_step_merged``, ``_lanes_solve``,
  ``_lanes_solve_panels`` and ``_panels_substitute`` op for op;
- the wrapper :func:`online_sweep_windowed_fused`, which runs the twin for
  CPU tensors and the hand-written CUDA kernel (``csrc/windowed_fused.cu``)
  for CUDA tensors. There is no fallback between the two.

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
identity). With paired LU (group G ≥ 2, mode ``sub1``, N > 20) each
schedule period starts with two full-LU steps, then groups of G steps in
which the leader factorizes and the G−1 followers solve with the
leader's factors plus one refinement against their own KN; a remainder
takes the per-step LU.

Table layouts are the reference's (padded NP = ``pad_dim(N)``, 8-aligned
θ row blocks ``[θm | θk…,1 | θf | g]``), because they are part of what
the serving prep produces. The TPU tiling (128-lane blocks, DMA chunks,
VMEM residency) is not carried over.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from .compensated import dd_add_small, dd_matvec, two_sum

PROBE_P = 8        # padded probe rows
GJ_FORI_MIN = 20   # above this N the solve is the blocked LU
LU_BLOCK = 8       # pivot block of the blocked LU


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


def _bdf_step_merged(tts, Bmk, BmF, BkF, Bf, uN, lo, uN1, lo1, step, TQ,
                     VE, dtb0, bdf2, n_real, NP, km8, kk8, kf8,
                     panels=None, save_panels=False):
    """One merged-dot residual-form BDF step (``_bdf_step_merged``)."""
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

    out_panels = None
    if panels is not None:
        # sub1 follower: substitute with the leader's panels, refine once
        # against this step's own KN.
        delta = panels_substitute(panels, r0, NP)
        resid = r0 - lanes_matvec(KN, delta)
        delta = delta + panels_substitute(panels, resid, NP)
    elif save_panels:
        delta, out_panels = lanes_solve_panels(KN, r0, NP)
    else:
        delta = lanes_solve(KN, r0, n_real, NP)
    uN_new, lo_new = dd_add_small(pred_hi, pred_lo, delta)
    probes = VE @ uN_new + tts[kmk8 + kf8:kmk8 + kf8 + PROBE_P]
    return uN_new, lo_new, probes, out_panels


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
                period):
    """Validate shapes/options; returns (W, width, NP, km, kk, period,
    group)."""
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
    if paired_lu and paired_mode != "sub1":
        raise ValueError(f"paired-LU mode {paired_mode!r} is not ported; "
                         "only 'sub1'")
    if paired_lu is not None and paired_lu < 0:
        raise ValueError("paired_lu must be None, 0 or a group size ≥ 2")
    period = width if period is None else int(period)
    if period < 1 or width % period:
        raise ValueError(f"period {period} must divide the window width "
                         f"{width}")
    # Panel reuse only pays above the blocked-LU threshold (reference:
    # the small-N Gauss-Jordan path ignores paired_lu).
    group = paired_lu if (paired_lu and paired_lu >= 2) else 0
    return W, width, NP, km, kk, period, group


def windowed_fused_reference(TH, Bmk, BmF, BkF, Bf, TQ, VE, Tp, b0, state0,
                             *, widths, dt, bdf2=True, with_trilinear=True,
                             n_real, km8, kk8, kf8, paired_lu=None,
                             paired_mode="sub1", period=None):
    """Plain PyTorch twin of K1; same arguments and results as
    :func:`online_sweep_windowed_fused`."""
    W, width, NP, _km, _kk, period, group = _check_args(
        TH, Bmk, BmF, BkF, Bf, TQ, VE, Tp, b0, state0, widths,
        with_trilinear, km8, kk8, kf8, paired_lu, paired_mode, period)
    if n_real <= GJ_FORI_MIN:
        group = 0
    if TH.is_cuda:
        _no_tf32()
    nt, _K8, B = TH.shape
    dt_c = torch.tensor(dt, dtype=TH.dtype, device=TH.device)
    dtb0 = dt_c * b0 if with_trilinear else None
    roles = step_roles(period, group)

    probes = TH.new_empty((nt, PROBE_P, B))
    uN, lo, uN1, lo1 = state0[0], state0[1], state0[2], state0[3]
    for w in range(W):
        T = Tp[w]
        uN, lo = dd_matvec(T, uN, lo)
        uN1, lo1 = dd_matvec(T, uN1, lo1)
        consts = (Bmk[w].T, BmF[w].T, BkF[w].T, Bf[w].T)
        TQ_w = TQ[w] if with_trilinear else None
        VE_w = VE[w]
        pan = None
        for s in range(width):
            step = w * width + s
            role = roles[s % period]
            uN_new, lo_new, probes[step], out_pan = _bdf_step_merged(
                TH[step], *consts, uN, lo, uN1, lo1, step, TQ_w, VE_w,
                dtb0, bdf2, n_real, NP, km8, kk8, kf8,
                panels=pan if role == "follow" else None,
                save_panels=role == "lead",
            )
            if role == "lead":
                pan = out_pan
            uN1, lo1, uN, lo = uN, lo, uN_new, lo_new
    return probes, torch.stack([uN, lo, uN1, lo1])


# ======================================================================
# CUDA kernel: build, bind, launch
# ======================================================================
_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "windowed_fused.cu"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_LIB = None


def build_dir():
    """Kernel build directory (listed in .gitignore): ``build/kernels``
    at the root of the checkout, or ``ROMTIME_TORCH_BUILD_DIR``."""
    env = os.environ.get("ROMTIME_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "kernels"


def build():
    """Compile K1's source with nvcc for sm_90a into a shared library
    keyed by the source hash; returns (path, seconds, compiler log). A
    library already built from the same source is reused."""
    source = _SOURCE
    src = source.read_bytes()
    tag = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"{source.stem}-{tag[:16]}.so"
    log_path = lib_path.with_suffix(".log")
    if lib_path.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return lib_path, 0.0, log
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *_NVCC_FLAGS, "-o", tmp, str(source)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source}:\n{log}")
    os.replace(tmp, lib_path)
    log_path.write_text(log)
    return lib_path, seconds, log


def _library():
    global _LIB
    if _LIB is None:
        path, _s, _log = build()
        lib = ctypes.CDLL(str(path))
        ptr = ctypes.c_void_p
        i32 = ctypes.c_int
        lib.romtime_windowed_fused.argtypes = (
            [ptr] * 12 + [i32] * 13 + [ctypes.c_float, ptr])
        lib.romtime_windowed_fused.restype = i32
        lib.romtime_cuda_error_string.argtypes = [i32]
        lib.romtime_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def online_sweep_windowed_fused(TH, Bmk, BmF, BkF, Bf, TQ, VE, Tp, b0,
                                state0, *, widths, dt, bdf2=True,
                                with_trilinear=True, n_real, km8, kk8, kf8,
                                paired_lu=None, paired_mode="sub1",
                                period=None):
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
    period : steps per grouping period (default: one window)

    Returns (probes (nt, PROBE_P, B), state (4, NP, B)), float32. CPU
    tensors run the twin; CUDA tensors launch the kernel (and count the
    launch in ``online_sweep_windowed_fused.launches``)."""
    args = (TH, Bmk, BmF, BkF, Bf, TQ, VE, Tp, b0, state0)
    kw = dict(widths=widths, dt=dt, bdf2=bdf2,
              with_trilinear=with_trilinear, n_real=n_real, km8=km8,
              kk8=kk8, kf8=kf8, paired_lu=paired_lu,
              paired_mode=paired_mode, period=period)
    if TH.device.type == "cpu":
        return windowed_fused_reference(*args, **kw)
    if TH.device.type != "cuda":
        raise ValueError(f"unsupported device {TH.device}")
    W, width, NP, km, kk, period, group = _check_args(
        *args, widths, with_trilinear, km8, kk8, kf8, paired_lu,
        paired_mode, period)
    if n_real <= GJ_FORI_MIN:
        group = 0
    if not with_trilinear:
        TQ = TH.new_zeros((1,))
    for name, t in zip(("TH", "Bmk", "BmF", "BkF", "Bf", "TQ", "VE", "Tp",
                        "b0", "state0"), (TH, Bmk, BmF, BkF, Bf, TQ, VE,
                                          Tp, b0, state0)):
        if t.dtype != torch.float32 or t.device != TH.device:
            raise ValueError(f"{name} must be float32 on {TH.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    _no_tf32()
    lib = _library()
    nt, _K8, B = TH.shape
    probes = torch.empty((nt, PROBE_P, B), dtype=torch.float32,
                         device=TH.device)
    state = torch.empty((4, NP, B), dtype=torch.float32, device=TH.device)
    stream = torch.cuda.current_stream(TH.device).cuda_stream
    with torch.cuda.device(TH.device):
        err = lib.romtime_windowed_fused(
            TH.data_ptr(), Bmk.data_ptr(), BmF.data_ptr(), BkF.data_ptr(),
            Bf.data_ptr(), TQ.data_ptr(), VE.data_ptr(), Tp.data_ptr(),
            b0.data_ptr(), state0.data_ptr(), probes.data_ptr(),
            state.data_ptr(),
            W, width, period, NP, B, km8, kk8, kf8, km, kk,
            int(bool(with_trilinear)), int(bool(bdf2)), group,
            float(dt), stream)
    if err != 0:
        raise RuntimeError("windowed_fused launch failed: "
                           + lib.romtime_cuda_error_string(err).decode())
    online_sweep_windowed_fused.launches += 1
    return probes, state


online_sweep_windowed_fused.launches = 0
