"""Global lanes engine, ``engine="lanes"`` (counterpart of
``RomConstructor._online_scan_batch``, ``romtime_tpu/rom/rom.py:681-829``):
the reference's engine for every mode on the global basis outside the
fused kernels' gate, and the one its S-ROM estimator runs.

Plain torch on the serving object's device, the μ batch in the last
(lane) axis, op for op the reference's scan body:

1. θ(μ, t) of every source over the whole time grid, (nt, k, B) each,
   through the reductors' ``_thetas_traced``: the raw gathered entries
   under float32 serving (they pair with the folded combine V·(PᵀU)⁻¹),
   the PᵀU solve in float64 (paired with ``basis_rom``).
2. While 2·nt·N²·B·itemsize bytes fit the precompute policy, MN, KLIN =
   dt·Σ(stiffness side) and fN = dt·rhs are materialized as (nt, N², B)
   tables; otherwise the operators are recombined from θ at every step.
3. Each step adds, for the piston family, the trilinear term
   b0·(T0 @ u*) with u* = 2u_n − u_{n−1} (u_n under BDF-1; the
   reference's T0 fast path, ``rom.py:1454-1473``), and solves
   K = bdf·M_N + dt·S_N by the unpivoted lanes elimination: in float32 in
   the residual form against the double-word carry (the windowed lanes
   engine's step, ``dd_predict``/``dd_correct``), in float64 on the plain
   BDF right-hand side, as the reference's ``COMPENSATED = "auto"`` does
   (``rom.py:518-523``).

Speed is not a goal: every step is a few hundred small launches.
"""

import numpy as np
import torch

from ...conventions import BDF
from ...ops.linalg import gauss_solve_lanes
from ...ops.windowed_fused import _no_tf32
from .windowed_fused import (
    MASS,
    PREP_TIME_CHUNK,
    RHS,
    stiffness_side,
    time_grid,
)
from .windowed_lanes import (
    dd_correct,
    dd_predict,
    output_dofs,
    stack_outputs,
    step_outputs,
)


def global_lanes_tables(gs, sources, mode, dtype, device,
                        state_dependent=True):
    """Constant device tables of the engine in ``dtype``: each source's
    combine ``C_<source>`` (n_out, k) that pairs with its θ (the global
    configuration's folded ``combine_<source>`` under float32, the
    reductor's ``basis_rom`` in float64), the trilinear state table
    ``T0`` (N², N) where the configuration has one, the basis end rows
    ``V_ends`` (2, N) and, in mode "full", the basis ``V`` (nh, N).
    Raises where a ``state_dependent`` family's configuration has no
    trilinear state table."""
    if state_dependent and gs.trilinear is None:
        raise NotImplementedError(
            "the global lanes engine needs the trilinear state table T0 "
            "(payload key 'trilinear'); the reference's in-body N-MDEIM "
            "fallback (rom.py:1454-1473) is not ported (ROADMAP Queue 1, "
            "item 7)")

    def dev(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    tbl = {f"C_{name}": dev(gs.combines[name] if red._folded_serving()
                            else red._serving_combine())
           for name, red in sources.items()}
    if gs.trilinear is not None:
        tbl["T0"] = dev(gs.trilinear)
    tbl["V_ends"] = dev(np.asarray(gs.basis)[[0, -1], :])
    if mode == "full":
        tbl["V"] = dev(gs.basis)
    return tbl


def theta_tables(sources, mu, ts):
    """name → θ (nt, k, B) over the time grid ``ts`` (nt,), assembled
    :data:`PREP_TIME_CHUNK` steps at a time."""
    out = {name: [] for name in sources}
    for a in range(0, ts.shape[0], PREP_TIME_CHUNK):
        t = ts[a:a + PREP_TIME_CHUNK, None]
        for name, red in sources.items():
            out[name].append(red._thetas_traced(mu, t).to(ts.dtype)
                             .permute(1, 0, 2))
    return {name: torch.cat(parts).contiguous()
            for name, parts in out.items()}


def table_bytes(nt, N, B, dtype):
    """The reference's ``mat_bytes``: the MN and KLIN tables, 2·nt·N²·B
    words of ``dtype``."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    return 2 * nt * N * N * B * itemsize


def lanes_branch(nt, N, B, dtype, precompute_choice):
    """``"matrices"`` (materialized tables) or ``"thetas"`` (per-step
    recombination), as the policy decides on :func:`table_bytes`."""
    return ("matrices" if precompute_choice(table_bytes(nt, N, B, dtype))
            else "thetas")


#: The stiffness-side source that follows the trilinear term in the sum.
NONLINEAR_LIFTING = "nonlinear_lifting"


def online_scan_batch(fom, gs, sources, tables, mu, mode, precompute_choice,
                      compensated=None):
    """The lanes sweep over the whole time grid. ``mu`` maps names to (B,)
    tensors, whose dtype is the sweep's; ``precompute_choice(bytes)`` is
    the serving object's policy; ``compensated`` the serving object's
    ``_compensated_active()`` (None: the residual form in float32, the
    plain step in float64, its ``"auto"``). Returns (nt, …, B) tensors: ``t`` and, by mode,
    ``probes`` (nt, 2, B) and ``uN_final`` (N, B) ("probes"), ``uN``
    (nt, N, B) and ``probes`` ("reduced"), ``uN``, ``uc`` and ``x``
    (nt, nh, B) ("full")."""
    ref = next(iter(mu.values()))
    dtype, device = ref.dtype, ref.device
    if ref.is_cuda:
        _no_tf32()
    B = ref.shape[0]
    nt = int(fom.domain[fom.NT])
    bdf2 = fom.BDF_SCHEME == BDF.TWO
    if compensated is None:
        compensated = dtype == torch.float32
    N = gs.N
    dt = torch.tensor(float(fom.dt), dtype=dtype, device=device)
    ts = time_grid(fom, None, dtype, device)
    stiff = stiffness_side(sources)

    thetas = theta_tables(sources, mu, ts)
    precompute = lanes_branch(nt, N, B, dtype, precompute_choice) == "matrices"
    if precompute:
        def combined(name):
            return torch.einsum("nk,tkB->tnB", tables[f"C_{name}"],
                                thetas[name])

        MN_tab = combined(MASS)
        KLIN_tab = dt * sum(combined(name) for name in stiff)
        fN_tab = dt * combined(RHS)
        del thetas

    T0 = tables.get("T0")
    b0 = fom.nonlinear_coefficient(mu) if T0 is not None else None
    lin = [n for n in stiff if n != NONLINEAR_LIFTING]
    tail = [n for n in stiff if n == NONLINEAR_LIFTING]
    x_dofs = output_dofs(fom, mode, dtype, device)
    V_full = tables.get("V")
    zeros = torch.zeros((N, B), dtype=dtype, device=device)
    carry = (zeros, zeros, zeros, zeros)
    steps = []
    for k in range(nt):
        uN_n, _, uN_n1, _ = carry
        NN = None
        if T0 is not None:
            u_star = 2.0 * uN_n - uN_n1 if bdf2 else uN_n
            NN = (T0 @ u_star).reshape(N, N, B) * b0
        if precompute:
            MN = MN_tab[k].reshape(N, N, B)
            dtS = KLIN_tab[k].reshape(N, N, B)
            if NN is not None:
                dtS = dtS + dt * NN
            fN = fN_tab[k]
        else:
            def get(name):
                return (tables[f"C_{name}"] @ thetas[name][k]).reshape(
                    N, N, B)

            MN = get(MASS)
            # The reference's order: A + C + N(u*) + N̂.
            terms = ([get(n) for n in lin] + ([NN] if NN is not None else [])
                     + [get(n) for n in tail])
            S = terms[0]
            for term in terms[1:]:
                S = S + term
            dtS = dt * S
            fN = dt * (tables[f"C_{RHS}"] @ thetas[RHS][k])
        if compensated:
            pred_hi, pred_lo, d, bdf = dd_predict(carry, bdf2 and k > 0)
            uN, lo = dd_correct(MN, dtS, fN, bdf, pred_hi, pred_lo, d)
        else:
            bdf = 1.5 if bdf2 and k > 0 else 1.0
            combo = 2.0 * uN_n - 0.5 * uN_n1 if bdf2 else uN_n
            uN = gauss_solve_lanes(
                bdf * MN + dtS,
                torch.einsum("ijB,jB->iB", MN, combo) + fN)
            lo = zeros
        steps.append(step_outputs(fom, mu, ts[k], uN, mode,
                                  tables["V_ends"], V_full, x_dofs))
        carry = (uN, lo, uN_n, carry[1])
    return stack_outputs(steps, mode, carry[0])
