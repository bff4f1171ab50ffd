"""Windowed serving engine (counterpart of
``romtime_tpu/rom/engines/windowed_pallas.py``).

Two stages, as in the reference:

1. :func:`windowed_tables` (reference ``:43-166``) stacks the per-window
   constants once, in the reference's layouts; :func:`windowed_prep`
   (``:168-261``) builds the θ tables by gathered DEIM-entry assembly over
   the whole time grid, the lifting probes ``g``, the trilinear
   coefficient ``b0`` and, with a dilation law, the per-lane dilation and
   its extrapolation flag (``:263-308``). Plain torch on the device,
   chunked over time to bound memory.
2. :func:`windowed_sweep` (``:310-488``) takes the reference's branch:
   materialized per-window operator tables and one K2 launch per window
   when the tables fit the precompute budget (:func:`sweep_materialized`),
   else the fused K1 over all windows (:func:`sweep_fused`, the default;
   its solve, the per-window Richardson or the paired LU, from the
   serving object's :class:`~.policy.SolvePolicy`) or, under
   ``ROMTIME_WINDOWED_KERNEL=v2``, one K3 launch per window
   (:func:`sweep_theta_v2`). Between per-window launches the dd carry is
   re-expressed through the window transfer with a double-word matvec.
"""

import numpy as np
import torch

from ...conventions import BDF
from ...ops.compensated import dd_matvec
from ...ops.resid_sweep import (
    online_sweep_pallas_v2,
    online_sweep_theta_pallas_v2,
)
from ...ops.windowed_fused import (
    PROBE_P,
    _no_tf32,
    online_sweep_windowed_fused,
    pad_dim,
)
from ..registration import GUARD_FACTOR, _feature_value
from .policy import paired_lu_period, windowed_kernel

MASS, RHS = "mass", "rhs_vec"


def _pad8(k):
    return -(-k // 8) * 8


def stiffness_side(sources):
    """θ sources on the dt-scaled stiffness side, in source order."""
    return [n for n in sources if n not in (MASS, RHS)]


def windowed_tables(win, dt, stiff_names, device):
    """Stacked per-window constants (float32 on ``device``).

    For K2/K3 (reference layouts, ``windowed_pallas.py:130-134``): Bm
    (W, NP², km8), Bk (W, NP², kk8) with the padded-diagonal identity
    column, Bf (W, NP, kf8), T0 (W, NP², NP), T (W, N, N) with T[0] = I.
    For the lane-major product of K2's and K4's tables
    (:func:`window_operators_lanes`): BmL (W, km8, NP·(NP + 4)) and BkL
    (W, kk8, NP·(NP + 4)), Bm and Bk transposed with each row of NP
    padded by 4 zero columns.
    For K1: Bmk (W, kfold, NP²) folded [Bm | Bk | T0], BmF/BkF
    (W, NP, k·NP) factored tensors, BfT (W, kf8, NP), TQ (W, NP, NP²),
    Tp (W, NP, NP) = T zero-padded. Both: VE (W, 8, NP), the θ row extents
    km8/kk8/kf8, and the dilation law's coefficients and guard when one is
    attached."""
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

    def lanes_combine(C, k8):
        out = np.zeros((W, k8, NP, NP + 4), np.float32)
        out[..., :NP] = C.reshape(W, NP, NP, k8).transpose(0, 3, 1, 2)
        return dev(out.reshape(W, k8, NP * (NP + 4)))

    tbl = {
        "km8": km8, "kk8": kk8, "kf8": kf8,
        "Bm": dev(Bm), "Bk": dev(Bk), "Bf": dev(Bf), "T0": dev(T0),
        "T": dev(T), "BmL": lanes_combine(Bm, km8),
        "BkL": lanes_combine(Bk, kk8),
        "Bmk": dev(Bmk.transpose(0, 2, 1)),
        "BmF": dev(BmF.transpose(0, 2, 1)),
        "BkF": dev(BkF.transpose(0, 2, 1)),
        "BfT": dev(Bf.transpose(0, 2, 1)),
        # T0 is [(i,j), k]: a plain reshape gives the [i, (j,k)] layout.
        "TQ": dev(T0.reshape(W, NP, NP * NP)),
        "VE": dev(VE),
        "Tp": dev(Tp),
    }
    tbl.update(dilation_tables(win.dilation, torch.float32, device))
    return tbl


def dilation_tables(law, dtype, device):
    """The dilation law's coefficients ``dil_coef`` and, with a guard,
    ``dil_guard_feats``/``dil_guard_inv_span``/``dil_guard_thresh`` in
    ``dtype`` on ``device`` (none without a law)."""
    if law is None:
        return {}

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    tbl = {"dil_coef": dev(law.coef)}
    if law.has_guard:
        tbl.update(dil_guard_feats=dev(law.guard_feats),
                   dil_guard_inv_span=dev(law.guard_inv_span),
                   dil_guard_thresh=dev(GUARD_FACTOR * law.guard_dref))
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


def entry_chunks(sources, mu, ts, dil):
    """The DEIM entries over the time grid ``ts`` ((nt,), or per-lane
    (nt, B) with the dilation ``dil``), :data:`PREP_TIME_CHUNK` steps at
    a time: yields (a, b, t, ent) for steps a..b−1 with their times ``t``
    ((b−a, 1) or (b−a, B)) and name → (b−a, k, B) entries in the times'
    dtype, the dt-side sources scaled by the lane's dilation (dt is
    folded into the combine tensors)."""
    nt = ts.shape[0]
    for a in range(0, nt, PREP_TIME_CHUNK):
        b = min(nt, a + PREP_TIME_CHUNK)
        t = ts[a:b] if dil is not None else ts[a:b, None]
        ent = {name: red._entries_traced(mu, t).to(ts.dtype).permute(1, 0, 2)
               for name, red in sources.items()}
        if dil is not None:
            for name in ent:
                if name != MASS:
                    ent[name] = ent[name] * dil[None, None, :]
        yield a, b, t, ent


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
    for a, b, t, ent in entry_chunks(sources, mu, ts, dil):
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


def window_width(win):
    """The common step count of the windows: every branch needs equal
    widths (reference ``:339-343``)."""
    widths = np.diff(np.asarray(win.bounds))
    if len(set(widths.tolist())) != 1:
        raise ValueError("windowed serving needs equal window widths")
    return int(widths[0])


def materialized_bytes(nt, NP, B):
    """Bytes of the whole sweep's MN and KL time tables, the quantity the
    precompute budget is held against (reference ``:361``)."""
    return 2 * nt * NP * NP * B * 4


def materialize(nt, NP, B, precompute_choice):
    """The reference's budget test, shared by the windowed and the global
    engine: whether ``precompute_choice`` accepts the materialized tables'
    bytes. Each engine picks its own θ-streaming kernel when it does not."""
    return precompute_choice(materialized_bytes(nt, NP, B))


def stage2_branch(nt, NP, B, precompute_choice):
    """The reference's stage-2 routing: ``"matrices"`` when
    :func:`materialize` holds, else
    :func:`~romtime_tpu_torch.rom.engines.policy.windowed_kernel`
    (``"fused"`` or ``"v2"``)."""
    if materialize(nt, NP, B, precompute_choice):
        return "matrices"
    return windowed_kernel()


def sweep_inputs(fom, win, prepped, tables, solve):
    """(args, kwargs) of the K1 call for a prepped batch: the merged θ
    table [THm | THk | THf | g], the stacked constants, b0, a fresh dd
    carry, and the solve (``solve`` = (solve_iters, paired-LU group,
    mode)) with the reference's paired-LU period."""
    solve_iters, group, mode = solve
    width = window_width(win)
    NP = pad_dim(win.N)
    B = prepped["THm"].shape[2]
    TH = torch.cat([prepped["THm"], prepped["THk"], prepped["THf"],
                    prepped["g"]], dim=1).to(torch.float32).contiguous()
    state0 = torch.zeros((4, NP, B), dtype=torch.float32, device=TH.device)
    args = (TH, tables["Bmk"], tables["BmF"], tables["BkF"], tables["BfT"],
            tables["TQ"], tables["VE"], tables["Tp"],
            prepped["b0"].to(torch.float32).contiguous(), state0)
    kw = dict(widths=(width,) * win.n_windows, dt=float(fom.dt),
              bdf2=fom.BDF_SCHEME == BDF.TWO,
              with_trilinear=win.trilinear is not None, n_real=win.N,
              km8=tables["km8"], kk8=tables["kk8"], kf8=tables["kf8"],
              paired_lu=group, paired_mode=mode, solve_iters=solve_iters,
              period=paired_lu_period(width, TH.shape[1], win.N))
    return args, kw


def sweep_fused(fom, win, prepped, tables, solve):
    """Fused branch (reference ``:429-451``): one K1 launch over all
    windows with ``solve`` (:func:`sweep_inputs`). Returns (probes
    (nt, 8, B), state (4, NP, B))."""
    args, kw = sweep_inputs(fom, win, prepped, tables, solve)
    return online_sweep_windowed_fused(*args, **kw)


def window_inputs(fom, win, prepped):
    """float32 θ tables, probes and b0 of a prepped batch, and the
    per-window kernels' keywords."""
    ops = [prepped[k].to(torch.float32).contiguous()
           for k in ("THm", "THk", "THf", "g", "b0")]
    kw = dict(dt=float(fom.dt), bdf2=fom.BDF_SCHEME == BDF.TWO,
              with_trilinear=win.trilinear is not None, n_real=win.N)
    return ops, kw


def _transfer(state, T):
    """Window-boundary transfer of the dd carry through T (N, N), both
    BDF registers, padded entries zero (reference ``transfer_state``,
    ``:364-377``). The two registers go through one dd matvec side by
    side (it works column by column, so the result is the same): the
    matvec is a few hundred small elementwise launches."""
    N = T.shape[0]
    B = state.shape[2]
    hi, lo = dd_matvec(T, torch.cat([state[0, :N], state[2, :N]], dim=1),
                       torch.cat([state[1, :N], state[3, :N]], dim=1))
    out = torch.zeros_like(state)
    out[0, :N], out[2, :N] = hi[:, :B], hi[:, B:]
    out[1, :N], out[3, :N] = lo[:, :B], lo[:, B:]
    return out


def window_operators(tables, w, THm, THk, THf, a, b):
    """Window w's materialized operators for steps a..b−1: MN, KL
    (b−a, NP, NP, B) and fN (b−a, NP, B), plain products of its combine
    tensors with its θ rows (the reference leaves them to XLA outside any
    kernel)."""
    NP = tables["VE"].shape[2]
    B = THm.shape[2]
    MN, KL = (torch.einsum("nk,tkB->tnB", tables[key][w], th[a:b])
              .reshape(b - a, NP, NP, B).contiguous()
              for key, th in (("Bm", THm), ("Bk", THk)))
    fN = torch.einsum("nk,tkB->tnB", tables["Bf"][w], THf[a:b]).contiguous()
    return MN, KL, fN


def window_operators_lanes(tables, w, THm, THk, THf, a, b):
    """:func:`window_operators` in the serving body's lane-major layout:
    MN, KL (b−a, B, NP, NP + 4), rows padded with exact zeros, and fN
    (b−a, B, NP), as the products θᵀ·[Bm | Bk | Bf]ᵀ with the operands
    swapped (``tables["BmL"]``/``["BkL"]``/``["BfT"]``), so K2 and K4
    read one contiguous tile per step and block without a conversion."""
    NP = tables["VE"].shape[2]
    B = THm.shape[2]
    MN, KL = (torch.matmul(th[a:b].transpose(1, 2), tables[key][w])
              .reshape(b - a, B, NP, NP + 4).contiguous()
              for key, th in (("BmL", THm), ("BkL", THk)))
    fN = torch.matmul(THf[a:b].transpose(1, 2),
                      tables["BfT"][w]).contiguous()
    return MN, KL, fN


def sweep_materialized(fom, win, prepped, tables):
    """Materialized branch (reference ``:381-414``): per window w, the dd
    transfer through T[w] (w > 0), the window's MN, KL and fN by a plain
    product of the combine tensors with its θ rows (lane-major,
    :func:`window_operators_lanes`), and one K2 launch with
    step0 = bounds[w]."""
    (THm, THk, THf, g, b0), kw = window_inputs(fom, win, prepped)
    NP = pad_dim(win.N)
    B = THm.shape[2]
    if THm.is_cuda:
        _no_tf32()
    state = THm.new_zeros((4, NP, B))
    parts = []
    for w in range(win.n_windows):
        a, b = int(win.bounds[w]), int(win.bounds[w + 1])
        if w > 0:
            state = _transfer(state, tables["T"][w])
        MN, KL, fN = window_operators_lanes(tables, w, THm, THk, THf, a, b)
        probes_w, state = online_sweep_pallas_v2(
            MN, KL, fN, g[a:b], tables["T0"][w], tables["VE"][w], b0,
            state, step0=a, lane_major=True, **kw)
        parts.append(probes_w)
    return torch.cat(parts), state


def live_rows(tables):
    """The live θm and θk rows of the window tables (the factored
    tensors' extents, as K1 reads them): the ``km``/``kk`` keywords of
    the θ-streaming kernels K3 and K5, which then stream no padded row."""
    NP = tables["VE"].shape[2]
    return dict(km=tables["BmF"].shape[2] // NP,
                kk=tables["BkF"].shape[2] // NP)


def sweep_theta_v2(fom, win, prepped, tables):
    """v2 branch (reference ``:453-488``): per window w, the dd transfer
    through T[w] (T[0] = I included) and one K3 launch with
    step0 = w·width over the live θ rows (:func:`live_rows`)."""
    (THm, THk, THf, g, b0), kw = window_inputs(fom, win, prepped)
    kw.update(live_rows(tables))
    width = window_width(win)
    NP = pad_dim(win.N)
    state = THm.new_zeros((4, NP, THm.shape[2]))
    parts = []
    for w in range(win.n_windows):
        a, b = w * width, (w + 1) * width
        state = _transfer(state, tables["T"][w])
        probes_w, state = online_sweep_theta_pallas_v2(
            THm[a:b], THk[a:b], THf[a:b], g[a:b], tables["Bm"][w],
            tables["Bk"][w], tables["Bf"][w], tables["T0"][w],
            tables["VE"][w], b0, state, step0=a, **kw)
        parts.append(probes_w)
    return torch.cat(parts), state


def windowed_sweep(fom, win, prepped, tables, policy):
    """Stage 2 through the branch :func:`stage2_branch` picks with
    ``policy.precompute_choice``; the fused branch solves as
    ``policy.windowed_solve()`` says. Returns (nt, …, B) tensors: t,
    probes (nt, 2, B), uN_final (N, B) and ``dil``/``dil_oor`` when the
    prep produced them."""
    window_width(win)
    THm = prepped["THm"]
    nt, _k, B = THm.shape
    branch = stage2_branch(nt, pad_dim(win.N), B, policy.precompute_choice)
    if branch == "fused":
        probes, state = sweep_fused(fom, win, prepped, tables,
                                    policy.windowed_solve())
    else:
        sweep = {"matrices": sweep_materialized,
                 "v2": sweep_theta_v2}[branch]
        probes, state = sweep(fom, win, prepped, tables)
    dil = prepped.get("dil")
    out = {"t": time_grid(fom, dil, THm.dtype, THm.device),
           "probes": probes[:, :2, :], "uN_final": state[0, :win.N, :]}
    for k in ("dil", "dil_oor"):
        if k in prepped:
            out[k] = prepped[k]
    return out
