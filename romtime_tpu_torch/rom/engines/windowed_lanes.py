"""Windowed lanes engine, ``engine="windowed"`` (counterpart of
``romtime_tpu/rom/engines/windowed_lanes.py:43-431``): the reference's
certification engine, over equal-width windows and, chained window by
window, over unequal widths.

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


def _matvec(M, v):
    return torch.einsum("ijB,jB->iB", M, v)


def dd_predict(carry, bdf2_step):
    """The BDF predictor of the double-word carry (hi, lo, hi1, lo1):
    (pred_hi, pred_lo, d, bdf), where pred is 2u_n − u_{n−1}, d the
    history difference u_n − u_{n−1} and bdf 1.5 on a BDF-2 step, else
    u_n, zero and 1.0."""
    uN_n, lo_n, uN_n1, lo_n1 = carry
    if bdf2_step:
        pred_hi, pred_lo = dd_bdf2_predict(uN_n, lo_n, uN_n1, lo_n1)
        return pred_hi, pred_lo, dd_history_diff(uN_n, lo_n, uN_n1,
                                                 lo_n1), 1.5
    return uN_n, lo_n, torch.zeros_like(uN_n), 1.0


def dd_correct(MN, dtS, fN, bdf, pred_hi, pred_lo, d):
    """The residual-form step after :func:`dd_predict`: K δ = M_N·d + f −
    dt·S·pred with K = bdf·M_N + dt·S by the unpivoted lanes elimination,
    then u = pred + δ in double words. Returns (hi, lo)."""
    r0 = _matvec(MN, d) + fN - _matvec(dtS, pred_hi)
    delta = gauss_solve_lanes(bdf * MN + dtS, r0)
    return dd_add_small(pred_hi, pred_lo, delta)


def output_dofs(fom, mode, dtype, device):
    """The reference mesh's dof coordinates (nh, 1) in mode "full", else
    None."""
    if mode != "full":
        return None
    return torch.as_tensor(fom.mesh.x_dofs, dtype=dtype, device=device)[:, None]


def step_outputs(fom, mu, t, uN, mode, V_ends, V_full, x_dofs):
    """One step's outputs (reference ``:264-290``): ``t`` and, by mode,
    ``uN``, the end probes V_ends·uN + g(0, L) or the full field
    V·uN + g(x) and its physical coordinates, with g the lifting on the
    scaled domain."""
    ones_b = torch.ones_like(uN[0])
    scale = fom.scale_factor(mu, t)
    L = float(fom.domain[fom.L0]) * scale * ones_b
    g = fom.create_lifting_operator(mu=mu, t=t, L=L, only_g=True)
    out = {"t": t} if mode == "probes" else {"uN": uN, "t": t}
    if mode == "full":
        x_phys = x_dofs * (scale * ones_b)
        out["uc"] = V_full @ uN + g(x_phys)
        out["x"] = x_phys
    else:
        x_ends = torch.stack([torch.zeros_like(L), L])
        out["probes"] = V_ends @ uN + g(x_ends)
    return out


def stack_outputs(steps, mode, uN_final):
    """The per-step output dicts stacked into (nt, …, B) tensors, with
    ``uN_final`` (N, B) in mode "probes"."""
    outs = {key: torch.stack([s[key] for s in steps]) for key in steps[0]}
    if mode == "probes":
        outs["uN_final"] = uN_final
    return outs


def _sweep_window(fom, carry, ts, k0, tabs, T0w, b0, V_ends, V_full, mu,
                  mode, x_dofs):
    """One window's steps in residual form (reference ``:206-290`` and
    ``:372-414``, the same step body): ``tabs`` = (MN, dt·S, dt·f) tables
    (width, N², B) / (width, N, B) of the window, whose first step is the
    global step ``k0``. Returns the carry after the window and the
    per-step output dicts."""
    MN_tab, dtS_tab, fN_tab = tabs
    B = MN_tab.shape[-1]
    N = carry[0].shape[0]
    bdf2 = fom.BDF_SCHEME == BDF.TWO
    dt = torch.tensor(float(fom.dt), dtype=MN_tab.dtype, device=MN_tab.device)
    steps = []
    for i in range(MN_tab.shape[0]):
        k = k0 + i
        MN = MN_tab[i].reshape(N, N, B)
        dtS = dtS_tab[i].reshape(N, N, B)
        pred_hi, pred_lo, d, bdf = dd_predict(carry, bdf2 and k > 0)
        if T0w is not None:
            dtS = dtS + dt * ((T0w @ pred_hi).reshape(N, N, B) * b0)
        uN, lo = dd_correct(MN, dtS, fN_tab[i], bdf, pred_hi, pred_lo, d)
        steps.append(step_outputs(fom, mu, ts[k], uN, mode, V_ends, V_full,
                                  x_dofs))
        carry = (uN, lo, carry[0], carry[1])
    return carry, steps


def _sweep_windows(fom, tables, mu, mode, ts, window_tabs, bounds, b0,
                   transfer_first):
    """Stage 2 over the windows: the carry re-expressed through each
    window's transfer (the first window's identity too when
    ``transfer_first``, as the equal-width engine scans it), then the
    window's steps. ``window_tabs(w)`` gives the window's tables.
    Returns the (nt, …, B) outputs of ``mode``."""
    ref = next(iter(mu.values()))
    dtype, device = ref.dtype, ref.device
    B = ref.shape[0]
    N = tables["T"].shape[1]
    x_dofs = output_dofs(fom, mode, dtype, device)
    zeros = torch.zeros((N, B), dtype=dtype, device=device)
    carry = (zeros, zeros, zeros, zeros)
    steps = []
    for w in range(len(bounds) - 1):
        if w > 0 or transfer_first:
            carry = _transfer_carry(carry, tables["T"][w], dtype)
        carry, out = _sweep_window(
            fom, carry, ts, int(bounds[w]), window_tabs(w),
            tables["T0"][w] if b0 is not None else None, b0,
            tables["V_ends"][w], tables["V_full"][w] if mode == "full"
            else None, mu, mode, x_dofs)
        steps += out
    return stack_outputs(steps, mode, carry[0])


def online_sweep_windowed(fom, win, sources, tables, mu, mode="probes"):
    """The lanes windowed sweep (reference ``_online_sweep_windowed``,
    ``:103-302``) over equal-width windows; unequal widths dispatch to
    :func:`online_sweep_windowed_chained`, as in the reference
    (``:119-121``). ``mu`` maps names to (B,) tensors; their dtype is the
    sweep's. Returns (nt, …, B) tensors: ``t`` and, by mode, ``probes``
    (nt, 2, B) and ``uN_final`` (N, B) ("probes"), ``uN`` (nt, N, B) and
    ``probes`` ("reduced"), ``uN``, ``uc`` and ``x`` (nt, nh, B)
    ("full"); ``dil``/``dil_oor`` with a dilation law."""
    widths = np.diff(np.asarray(win.bounds))
    if len(set(widths.tolist())) != 1:
        return online_sweep_windowed_chained(fom, win, sources, tables, mu,
                                             mode)
    ref = next(iter(mu.values()))
    dtype, device = ref.dtype, ref.device
    if ref.is_cuda:
        _no_tf32()
    nt = int(fom.domain[fom.NT])
    W = win.n_windows
    width = nt // W
    dt = torch.tensor(float(fom.dt), dtype=dtype, device=device)

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
    outs = _sweep_windows(
        fom, tables, mu, mode, ts,
        lambda w: (MN_tab[w], dtS_tab[w], fN_tab[w]),
        np.asarray(win.bounds), b0, transfer_first=True)
    if dil is not None:
        outs["dil"] = dil
        oor = windowed_dilation_oor(win, mu, tables)
        if oor is not None:
            outs["dil_oor"] = oor
    return outs


def online_sweep_windowed_chained(fom, win, sources, tables, mu,
                                  mode="probes"):
    """The per-window chained sweep (reference
    ``_online_sweep_windowed_chained``, ``:305-431``), the unequal-width
    variant: each window's operator tables are formed from its own slice
    of the entries, the carry is re-expressed through the transfer at each
    boundary after the first, and the step body is the equal-width
    engine's. Same arguments and outputs as
    :func:`online_sweep_windowed`; it serves equal widths too. Registered
    (dilated) serving raises, as in the reference."""
    if win.dilation is not None:
        raise NotImplementedError(
            "phase-aligned (registered) serving requires equal window "
            "widths — the unequal-width chained fallback does not carry "
            "per-lane dilated clocks")
    ref = next(iter(mu.values()))
    dtype, device = ref.dtype, ref.device
    if ref.is_cuda:
        _no_tf32()
    dt = torch.tensor(float(fom.dt), dtype=dtype, device=device)
    ts = time_grid(fom, None, dtype, device)
    chunks = list(entry_chunks(sources, mu, ts, None))
    ent = {name: torch.cat([c[3][name] for c in chunks]) for name in sources}
    del chunks
    stiff = stiffness_side(sources)
    b0 = fom.nonlinear_coefficient(mu) if win.trilinear is not None else None
    bounds = np.asarray(win.bounds)

    def window_tabs(w):
        a, b = int(bounds[w]), int(bounds[w + 1])

        def table(name):
            return torch.einsum("nk,tkB->tnB", tables[f"C_{name}"][w],
                                ent[name][a:b])

        return (table(MASS), dt * sum(table(n) for n in stiff),
                dt * table(RHS))

    return _sweep_windows(fom, tables, mu, mode, ts, window_tabs, bounds,
                          b0, transfer_first=False)
