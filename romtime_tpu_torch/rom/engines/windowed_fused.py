"""Fused windowed serving engine (counterpart of
``romtime_tpu/rom/engines/windowed_pallas.py``).

Two stages, as in the reference:

1. :func:`windowed_tables` (reference ``:43-166``) stacks the per-window
   constants once, in the reference's layouts; :func:`windowed_prep`
   (``:168-261``) builds the θ tables by gathered DEIM-entry assembly over
   the whole time grid, the lifting probes ``g``, the trilinear
   coefficient ``b0`` and, with a dilation law, the per-lane dilation and
   its extrapolation flag (``:263-308``). Plain torch on the device,
   chunked over time to bound memory.
2. :func:`windowed_sweep` (``:429-451``, the fused dispatch) runs the
   whole trajectory through K1 (``ops/windowed_fused.py``).
"""

import numpy as np
import torch

from ...conventions import BDF
from ...ops.windowed_fused import (
    PROBE_P,
    online_sweep_windowed_fused,
    pad_dim,
)
from ..registration import GUARD_FACTOR, _feature_value

MASS, RHS = "mass", "rhs_vec"


def _pad8(k):
    return -(-k // 8) * 8


def stiffness_side(sources):
    """θ sources on the dt-scaled stiffness side, in source order."""
    return [n for n in sources if n not in (MASS, RHS)]


def windowed_tables(win, dt, stiff_names, device):
    """Stacked per-window constants (float32 on ``device``).

    Bmk (W, kfold, NP²) folded [Bm | Bk | T0], BmF/BkF (W, NP, k·NP)
    factored tensors, BfT (W, kf8, NP), TQ (W, NP, NP²), VE (W, 8, NP),
    Tp (W, NP, NP) with Tp[0] = I; the θ row extents km8/kk8/kf8; and
    the dilation law's coefficients and guard when one is attached."""
    N = win.N
    NP = pad_dim(N)
    W = win.n_windows
    dt = float(dt)
    km = win.combines[MASS].shape[2]
    km8 = _pad8(km)
    kk = sum(win.combines[n].shape[2] for n in stiff_names) + 1
    kk8 = _pad8(kk)
    kf = win.combines[RHS].shape[2]
    kf8 = _pad8(kf)

    Bm = np.zeros((W, NP * NP, km8), np.float32)
    Bk = np.zeros((W, NP * NP, kk8), np.float32)
    Bf = np.zeros((W, NP, kf8), np.float32)
    VE = np.zeros((W, PROBE_P, NP), np.float32)
    T0 = np.zeros((W, NP * NP, NP), np.float32)
    for w in range(W):
        bm = np.zeros((NP, NP, km8), np.float32)
        bm[:N, :N, :km] = win.combines[MASS][w].reshape(N, N, km)
        Bm[w] = bm.reshape(NP * NP, km8)
        bk = np.zeros((NP, NP, kk8), np.float32)
        col = 0
        for n in stiff_names:
            Cw = win.combines[n][w]
            k = Cw.shape[1]
            bk[:N, :N, col:col + k] = Cw.reshape(N, N, k) * dt
            col += k
        # The appended constant-1 θ row carries the padded diagonal.
        bk[np.arange(N, NP), np.arange(N, NP), col] = 1.0
        Bk[w] = bk.reshape(NP * NP, kk8)
        Bf[w, :N, :kf] = win.combines[RHS][w] * dt
        VE[w, :2, :N] = win.Vs[w][[0, -1], :]
        if win.trilinear is not None:
            t0 = np.zeros((NP, NP, NP), np.float32)
            t0[:N, :N, :N] = win.trilinear[w].reshape(N, N, N)
            T0[w] = t0.reshape(NP * NP, NP)
    T = np.concatenate([np.eye(N, dtype=np.float32)[None],
                        np.asarray(win.transfers, np.float32)], axis=0)
    Tp = np.zeros((W, NP, NP), np.float32)
    Tp[:, :N, :N] = T
    with_tri = win.trilinear is not None
    Bmk = np.concatenate([Bm, Bk] + ([T0] if with_tri else []), axis=2)
    BmF = (Bm[:, :, :km].reshape(W, NP, NP, km)
           .transpose(0, 3, 1, 2).reshape(W, km * NP, NP))
    BkF = (Bk[:, :, :kk].reshape(W, NP, NP, kk)
           .transpose(0, 3, 1, 2).reshape(W, kk * NP, NP))

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    tbl = {
        "km8": km8, "kk8": kk8, "kf8": kf8,
        "Bmk": dev(Bmk.transpose(0, 2, 1)),
        "BmF": dev(BmF.transpose(0, 2, 1)),
        "BkF": dev(BkF.transpose(0, 2, 1)),
        "BfT": dev(Bf.transpose(0, 2, 1)),
        # T0 is [(i,j), k]: a plain reshape gives the [i, (j,k)] layout.
        "TQ": dev(T0.reshape(W, NP, NP * NP)),
        "VE": dev(VE),
        "Tp": dev(Tp),
    }
    law = win.dilation
    if law is not None:
        tbl["dil_coef"] = dev(np.asarray(law.coef, np.float32))
        if law.has_guard:
            tbl["dil_guard_feats"] = dev(np.asarray(law.guard_feats,
                                                    np.float32))
            tbl["dil_guard_inv_span"] = dev(np.asarray(law.guard_inv_span,
                                                       np.float32))
            tbl["dil_guard_thresh"] = dev(np.asarray(
                GUARD_FACTOR * law.guard_dref, np.float32))
    return tbl


def windowed_dilation(win, mu, coef):
    """Per-lane dilation d(μ_b) = max(c₀ + Σ cᵢ·fᵢ(μ_b), floor); None
    without a law."""
    law = win.dilation
    if law is None or coef is None:
        return None
    d = coef[0]
    for i, n in enumerate(law.names):
        d = d + coef[i + 1] * _feature_value(mu, n)
    d = d * torch.ones_like(next(iter(mu.values())))
    return torch.clamp(d, min=law.floor)


def windowed_dilation_oor(win, mu, tables):
    """Per-lane extrapolation flag (1.0 where the lane's μ lies beyond
    GUARD_FACTOR × the training fill distance of the law's feature
    cloud); None without a guard."""
    law = win.dilation
    G = tables.get("dil_guard_feats")
    if law is None or G is None:
        return None
    inv_span = tables["dil_guard_inv_span"]
    thresh = tables["dil_guard_thresh"]
    ones_b = torch.ones_like(next(iter(mu.values())))
    x = torch.stack([_feature_value(mu, n) * inv_span[i] * ones_b
                     for i, n in enumerate(law.names)], dim=-1)
    d2 = ((x[:, None, :] - G[None, :, :]) ** 2).sum(-1).min(dim=1).values
    return (d2 > thresh * thresh).to(torch.float32)


def time_grid(fom, dil, dtype, device):
    """(nt,) serving times (k+1)·dt, or (nt, B) per-lane dilated times."""
    nt = int(fom.domain[fom.NT])
    dt = torch.tensor(float(fom.dt), dtype=dtype, device=device)
    ts = (torch.arange(nt, device=device) + 1).to(dtype) * dt
    if dil is not None:
        ts = ts[:, None] * dil[None, :].to(dtype)
    return ts


#: Time steps assembled per prep chunk: bounds the (elements, quadrature,
#: steps, lanes) coefficient tensors to ~0.1 GB at B=2048.
PREP_TIME_CHUNK = 256


def windowed_prep(fom, sources, win, tables, mu):
    """Stage 1: θ entry tables THm (nt, km8, B), THk (nt, kk8, B) with
    the appended constant-1 row, THf (nt, kf8, B), lifting probes g
    (nt, 8, B), b0 (1, B), and ``dil``/``dil_oor`` with a law.

    ``mu`` maps names to (B,) tensors on the serving device; the dtype of
    the tables is theirs."""
    ref = next(iter(mu.values()))
    dtype, device = ref.dtype, ref.device
    B = ref.shape[0]
    nt = int(fom.domain[fom.NT])
    dil = windowed_dilation(win, mu, tables.get("dil_coef"))
    ts = time_grid(fom, dil, dtype, device)
    stiff = stiffness_side(sources)
    km8, kk8, kf8 = tables["km8"], tables["kk8"], tables["kf8"]

    def padded(rows, k8):
        th = torch.cat(rows, dim=1)
        pad = k8 - th.shape[1]
        if pad:
            th = torch.cat([th, th.new_zeros((th.shape[0], pad, B))], dim=1)
        return th

    THm = torch.empty((nt, km8, B), dtype=dtype, device=device)
    THk = torch.empty((nt, kk8, B), dtype=dtype, device=device)
    THf = torch.empty((nt, kf8, B), dtype=dtype, device=device)
    g = torch.zeros((nt, PROBE_P, B), dtype=dtype, device=device)
    L0 = float(fom.domain[fom.L0])
    for a in range(0, nt, PREP_TIME_CHUNK):
        b = min(nt, a + PREP_TIME_CHUNK)
        # (T, 1) or (T, B) times broadcast against (B,) μ lanes.
        t = ts[a:b] if dil is not None else ts[a:b, None]
        ent = {name: red._entries_traced(mu, t).to(dtype).permute(1, 0, 2)
               for name, red in sources.items()}          # (T, k, B)
        if dil is not None:
            for name in ent:
                if name != MASS:
                    # dt-side terms: the θ stream carries d_b (dt is
                    # folded into the combine tensors).
                    ent[name] = ent[name] * dil[None, None, :]
        THm[a:b] = padded([ent[MASS]], km8)
        THk[a:b] = padded([ent[n] for n in stiff]
                          + [ent[MASS].new_ones((b - a, 1, B))], kk8)
        THf[a:b] = padded([ent[RHS]], kf8)

        L = L0 * fom.scale_factor(mu, t) * torch.ones(
            (b - a, B), dtype=dtype, device=device)
        g_fn = fom.create_lifting_operator(mu=mu, t=t, L=L, only_g=True)
        g[a:b, :2] = g_fn(torch.stack([torch.zeros_like(L), L])).permute(
            1, 0, 2).to(dtype)

    if win.trilinear is not None:
        b0 = fom.nonlinear_coefficient(mu).to(dtype) * torch.ones(
            (B,), dtype=dtype, device=device)
        if dil is not None:
            b0 = b0 * dil
        b0 = b0[None, :]
    else:
        b0 = torch.ones((1, B), dtype=dtype, device=device)
    out = {"THm": THm, "THk": THk, "THf": THf, "g": g, "b0": b0}
    if dil is not None:
        out["dil"] = dil.to(dtype)
        oor = windowed_dilation_oor(win, mu, tables)
        if oor is not None:
            out["dil_oor"] = oor
    return out


#: Lanes and pivot/row floor of the pivot-free LU check.
PIVOT_CHECK_LANES = (0, -1)
PIVOT_FLOOR = 1e-3


def certify_pivot_free(tables, prepped, N):
    """Pivot-free LU safety check before any launch: the unpivoted LU of
    the window-entry solve matrix (state-free part bdf·MN + dt·S) of the
    first and last lane, in float64, must keep every pivot above
    PIVOT_FLOOR × its row's largest entry. Returns the smallest such
    ratio; raises below it."""
    Bmk = tables["Bmk"].double().cpu()
    W = Bmk.shape[0]
    NP = tables["VE"].shape[2]
    km8, kk8 = tables["km8"], tables["kk8"]
    nt = prepped["THm"].shape[0]
    width = nt // W
    worst = np.inf
    for w in range(W):
        step = w * width
        bdf = 1.0 if step == 0 else 1.5
        th = torch.cat([prepped["THm"][step] * bdf, prepped["THk"][step]],
                       dim=0)[:, list(PIVOT_CHECK_LANES)].double().cpu()
        K = (Bmk[w, :km8 + kk8].T @ th).reshape(NP, NP, -1)
        for b in range(K.shape[2]):
            A = K[:N, :N, b].numpy().copy()
            for k in range(N):
                ratio = abs(A[k, k]) / max(np.abs(A[k]).max(), 1e-300)
                worst = min(worst, ratio)
                A[k + 1:] -= np.outer(A[k + 1:, k] / A[k, k], A[k])
    if not np.isfinite(worst) or worst < PIVOT_FLOOR:
        raise ValueError(
            f"serving solve matrices are not safe for the pivot-free LU "
            f"(smallest pivot/row ratio {worst:.3g} < {PIVOT_FLOOR})")
    return worst


def sweep_inputs(fom, win, prepped, tables, group, mode):
    """(args, kwargs) of the K1 call for a prepped batch: the merged θ
    table [THm | THk | THf | g], the stacked constants, b0 and a fresh
    dd carry."""
    widths = np.diff(np.asarray(win.bounds))
    if len(set(widths.tolist())) != 1:
        raise ValueError("fused windowed serving needs equal window widths")
    NP = pad_dim(win.N)
    B = prepped["THm"].shape[2]
    TH = torch.cat([prepped["THm"], prepped["THk"], prepped["THf"],
                    prepped["g"]], dim=1).to(torch.float32).contiguous()
    state0 = torch.zeros((4, NP, B), dtype=torch.float32, device=TH.device)
    args = (TH, tables["Bmk"], tables["BmF"], tables["BkF"], tables["BfT"],
            tables["TQ"], tables["VE"], tables["Tp"],
            prepped["b0"].to(torch.float32).contiguous(), state0)
    kw = dict(widths=tuple(int(x) for x in widths), dt=float(fom.dt),
              bdf2=fom.BDF_SCHEME == BDF.TWO,
              with_trilinear=win.trilinear is not None, n_real=win.N,
              km8=tables["km8"], kk8=tables["kk8"], kf8=tables["kf8"],
              paired_lu=group, paired_mode=mode)
    return args, kw


def windowed_sweep(fom, win, prepped, tables, group, mode):
    """Stage 2: the fused K1 sweep over all windows. Returns (nt, …, B)
    tensors: t, probes (nt, 2, B), uN_final (N, B) and ``dil``/``dil_oor``
    when the prep produced them."""
    args, kw = sweep_inputs(fom, win, prepped, tables, group, mode)
    probes, state = online_sweep_windowed_fused(*args, **kw)
    THm = prepped["THm"]
    dil = prepped.get("dil")
    out = {"t": time_grid(fom, dil, THm.dtype, THm.device),
           "probes": probes[:, :2, :], "uN_final": state[0, :win.N, :]}
    for k in ("dil", "dil_oor"):
        if k in prepped:
            out[k] = prepped[k]
    return out
