"""Windowed lanes engine, ``engine="windowed"`` (counterpart of
``romtime_tpu/rom/engines/windowed_lanes.py:43-303``): the reference's
certification engine.

Plain torch on the serving object's device, the μ batch in the last
(lane) axis. Stage 1 assembles the DEIM entries over the whole (per-lane
dilated) time grid and stacks each window's operator time tables from its
combine tensors; stage 2 steps window by window in residual form,
re-expressing the carry at each boundary through the window transfer.
In float64 the carry is plain; in float32 it is the double-word carry of
``ops/compensated.py`` (dd predictor and update, dd transfer matvec), as
the reference serves it. Speed is not a goal: every step is a few dozen
small launches and a Python-level Gauss-Jordan.
"""

import numpy as np
import torch

from ...conventions import BDF
from ...ops.compensated import (
    dd_add_small,
    dd_bdf2_predict,
    dd_history_diff,
    dd_matvec,
)
from ...ops.linalg import gauss_solve_lanes
from ...ops.windowed_fused import _no_tf32
from .windowed_fused import (
    MASS,
    RHS,
    dilation_tables,
    entry_chunks,
    stiffness_side,
    time_grid,
    windowed_dilation,
    windowed_dilation_oor,
)

#: The modes ``solve_batch`` serves on this engine.
MODES = ("probes", "reduced", "full")


def _transfer_carry(carry, T, dtype):
    """Re-express the BDF carry (hi, lo, hi1, lo1) through the transfer T
    (reference ``:40-61``): a dd matvec in float32, ``T@h + T@l`` with a
    zero low word in float64."""
    if dtype == torch.float32:
        def tx(h, lo):
            return dd_matvec(T, h, lo)
    else:
        def tx(h, lo):
            return T @ h + T @ lo, torch.zeros_like(h)
    hi, lo, hi1, lo1 = carry
    a = tx(hi, lo)
    b = tx(hi1, lo1)
    return (a[0], a[1], b[0], b[1])


def windowed_lanes_tables(win, sources, mode, dtype, device):
    """Stacked per-window tensors of the lanes engine in ``dtype`` on
    ``device`` (reference ``:63-101``): the combines ``C_<source>``
    (W, n_out, k), ``T0`` (W, N², N), the end rows ``V_ends`` (W, 2, N),
    ``T`` (W, N, N) with T[0] = I, ``V_full`` (W, nh, N) in mode "full",
    and the dilation law's coefficients and guard."""
    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    tbl = {f"C_{name}": dev(win.combines[name]) for name in sources}
    if win.trilinear is not None:
        tbl["T0"] = dev(win.trilinear)
    tbl["V_ends"] = dev(np.asarray(win.Vs)[:, [0, -1], :])
    tbl.update(dilation_tables(win.dilation, dtype, device))
    if mode == "full":
        tbl["V_full"] = dev(win.Vs)
    tbl["T"] = dev(np.concatenate([np.eye(win.N)[None],
                                   np.asarray(win.transfers)], axis=0))
    return tbl


def online_sweep_windowed(fom, win, sources, tables, mu, mode="probes"):
    """The lanes windowed sweep (reference ``_online_sweep_windowed``,
    ``:103-302``) over equal-width windows. ``mu`` maps names to (B,)
    tensors; their dtype is the sweep's. Returns (nt, …, B) tensors: ``t``
    and, by mode, ``probes`` (nt, 2, B) and ``uN_final`` (N, B)
    ("probes"), ``uN`` (nt, N, B) and ``probes`` ("reduced"), ``uN``,
    ``uc`` and ``x`` (nt, nh, B) ("full"); ``dil``/``dil_oor`` with a
    dilation law."""
    widths = np.diff(np.asarray(win.bounds))
    if len(set(widths.tolist())) != 1:
        raise NotImplementedError(
            "windows of unequal widths take the reference's chained lanes "
            "variant (windowed_lanes.py:305), which is not ported "
            "(ROADMAP Queue 1, item 2)")
    ref = next(iter(mu.values()))
    dtype, device = ref.dtype, ref.device
    if ref.is_cuda:
        _no_tf32()
    B = ref.shape[0]
    nt = int(fom.domain[fom.NT])
    bdf2 = fom.BDF_SCHEME == BDF.TWO
    N, W = win.N, win.n_windows
    width = nt // W
    dt = torch.tensor(float(fom.dt), dtype=dtype, device=device)
    L0 = float(fom.domain[fom.L0])

    dil = windowed_dilation(win, mu, tables.get("dil_coef"))
    if dil is not None:
        dil = dil.to(dtype)
    ts = time_grid(fom, dil, dtype, device)
    chunks = list(entry_chunks(sources, mu, ts, dil))
    ent = {name: torch.cat([c[3][name] for c in chunks]) for name in sources}
    del chunks
    stiff = stiffness_side(sources)
    b0 = None
    if win.trilinear is not None:
        b0 = fom.nonlinear_coefficient(mu)
        if dil is not None:
            b0 = b0 * dil       # dt_b·N(u) = (d_b·b0)·dt·N₁(u)

    def wtable(name):
        e = ent[name]
        return torch.einsum("Wnk,WtkB->WtnB", tables[f"C_{name}"],
                            e.reshape((W, width) + e.shape[1:]))

    MN_tab = wtable(MASS)
    dtS_tab = dt * sum(wtable(n) for n in stiff)
    fN_tab = dt * wtable(RHS)
    del ent

    def matvec(M, v):
        return torch.einsum("ijB,jB->iB", M, v)

    x_dofs = None
    if mode == "full":
        x_dofs = torch.as_tensor(fom.mesh.x_dofs, dtype=dtype,
                                 device=device)[:, None]
    ones_b = torch.ones((B,), dtype=dtype, device=device)
    zeros = torch.zeros((N, B), dtype=dtype, device=device)
    carry = (zeros, zeros, zeros, zeros)
    steps = []
    for w in range(W):
        carry = _transfer_carry(carry, tables["T"][w], dtype)
        T0w = tables["T0"][w] if b0 is not None else None
        for i in range(width):
            k = w * width + i
            uN_n, lo_n, uN_n1, lo_n1 = carry
            t = ts[k]
            MN = MN_tab[w, i].reshape(N, N, B)
            dtS = dtS_tab[w, i].reshape(N, N, B)
            if bdf2 and k > 0:
                pred_hi, pred_lo = dd_bdf2_predict(uN_n, lo_n, uN_n1, lo_n1)
                d = dd_history_diff(uN_n, lo_n, uN_n1, lo_n1)
                bdf = 1.5
            else:
                pred_hi, pred_lo = uN_n, lo_n
                d = torch.zeros_like(uN_n)
                bdf = 1.0
            if T0w is not None:
                NN = (T0w @ pred_hi).reshape(N, N, B) * b0
                dtS = dtS + dt * NN
            KN = bdf * MN + dtS
            r0 = matvec(MN, d) + fN_tab[w, i] - matvec(dtS, pred_hi)
            delta = gauss_solve_lanes(KN, r0)
            uN, lo = dd_add_small(pred_hi, pred_lo, delta)

            scale = fom.scale_factor(mu, t)
            L = L0 * scale * ones_b
            g = fom.create_lifting_operator(mu=mu, t=t, L=L, only_g=True)
            out = {"t": t} if mode == "probes" else {"uN": uN, "t": t}
            if mode == "full":
                x_phys = x_dofs * (scale * ones_b)
                out["uc"] = tables["V_full"][w] @ uN + g(x_phys)
                out["x"] = x_phys
            else:
                x_ends = torch.stack([torch.zeros_like(L), L])
                out["probes"] = tables["V_ends"][w] @ uN + g(x_ends)
            steps.append(out)
            carry = (uN, lo, uN_n, lo_n)
    outs = {key: torch.stack([s[key] for s in steps]) for key in steps[0]}
    if mode == "probes":
        outs["uN_final"] = carry[0]
    if dil is not None:
        outs["dil"] = dil
        oor = windowed_dilation_oor(win, mu, tables)
        if oor is not None:
            outs["dil_oor"] = oor
    return outs
