"""Plain reference of the served ROM (PyTorch, float64 by default): from
a serving payload and a few μ rows, everything the program derives and
serves, worked out again.

Per row: its Mach cell (a fleet) and that cell's dilation d(μ) with the
guard's flag; the time grid tₙ = (n+1)·dt·d; the θ entries of every
source at its dofs on the moving mesh (:mod:`.assembly`), those on the
dt side scaled by d; per window w the reduced operators

    M = Σ_k C_mass[:, k]·θ_mass,k          K = dt·Σ_s Σ_k C_s[:, k]·θ_s,k
    f = dt·Σ_k C_rhs[:, k]·θ_rhs,k          N(u)_ij = dt·b0·d·Σ_k T_ijk·u_k

(b0 = (γ+1)/2·a0, s over the stiffness, convection and nonlinear lifting
sources), and from a zero state the semi-implicit BDF-2 march

    n = 0:  (M + K + N(u₀))·u₁ = M·u₀ + f
    n ≥ 1:  (1.5·M + K + N(u*))·uₙ₊₁ = M·(2uₙ − ½uₙ₋₁) + f,  u* = 2uₙ − uₙ₋₁

with both history states carried through the window transfer T_w before
each window after the first, and the probes at the two ends of the mesh,
p₀ = V_w[0]·uₙ₊₁ and p₁ = V_w[−1]·uₙ₊₁ + bL(tₙ). A global ROM is the one
window case. Each step is one batched dense solve.
"""

import numpy as np
import torch

from . import assembly
from .mach import band_of, mach

STIFF_SIDE = ("stiffness", "convection", "nonlinear_lifting")


def _t(a, dtype, device):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def cell_of(payload, mus):
    """Cell index of each μ row (a fleet), or zeros (a global ROM)."""
    n = len(mus["a0"])
    if "edges" not in payload:
        return np.zeros(n, np.int64)
    return band_of(payload["edges"], mach(mus["a0"], mus["omega"],
                                          mus["delta"]))


def cell_parts(payload, c):
    """The windows of cell c as plain arrays: bounds, Vs end rows
    (W, 2, N), transfers (W−1, N, N), combines, trilinear (W, N², N) and
    the dilation keys (none on a global ROM or an unregistered cell)."""
    if "edges" not in payload:
        nt = int(payload["fom_nt"])
        basis = np.asarray(payload["basis"])
        N = basis.shape[1]
        return {"bounds": np.array([0, nt]),
                "ends": basis[[0, -1]][None],
                "transfers": np.zeros((0, N, N)),
                "combines": {k[len("combine_"):]: np.asarray(v)[None]
                             for k, v in payload.items()
                             if k.startswith("combine_")},
                "trilinear": np.asarray(payload["trilinear"])[None],
                "law": None}
    pre = f"c{c}_"
    Vs = np.asarray(payload[pre + "Vs"])
    law = None
    if pre + "dilation_coef" in payload:
        law = {k: payload[pre + "dilation_" + k] for k in
               ("names", "coef", "floor", "guard_feats", "guard_inv_span",
                "guard_dref") if pre + "dilation_" + k in payload}
    return {"bounds": np.asarray(payload[pre + "bounds"]),
            "ends": Vs[:, [0, -1], :],
            "transfers": np.asarray(payload[pre + "transfers"]),
            "combines": {k[len(pre + "combine_"):]: np.asarray(v)
                         for k, v in payload.items()
                         if k.startswith(pre + "combine_")},
            "trilinear": np.asarray(payload[pre + "trilinear"]),
            "law": law}


GUARD_FACTOR = 1.5


def dilation(law, mu):
    """(d, oor, margin) per row of a guarded law: d = max(c₀ + Σ cᵢ·μᵢ,
    floor); oor 1.0 where the normalized feature lies farther than
    GUARD_FACTOR × the fill distance from every training point; margin the
    distance's relative gap to that threshold."""
    coef = np.asarray(law["coef"], np.float64)
    d = coef[0] + 0.0 * mu["a0"]
    for i, name in enumerate(np.asarray(law["names"]).tolist()):
        d = d + coef[i + 1] * mu[str(name)]
    d = torch.clamp(d, min=float(law["floor"]))
    if "guard_feats" not in law:
        return d, None, None
    inv_span = np.asarray(law["guard_inv_span"], np.float64)
    x = torch.stack([mu[str(n)] * float(inv_span[i]) for i, n in
                     enumerate(np.asarray(law["names"]).tolist())], dim=-1)
    G = _t(law["guard_feats"], x.dtype, x.device)
    dist = ((x[:, None, :] - G[None]) ** 2).sum(-1).min(dim=1).values.sqrt()
    thresh = GUARD_FACTOR * float(law["guard_dref"])
    return d, (dist > thresh).to(x.dtype), (dist - thresh).abs() / thresh


def tf32(x):
    """float32 ``x`` rounded to TF32's 10-bit mantissa (to nearest, ties
    away from zero): what a TF32 tensor core reads of an operand."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def sweep_rows(payload, config, c, mus, dtype=torch.float64, device="cpu",
               tf32_products=False):
    """The reference's probes (b, nt, 2), final states (b, N), the
    state's size over the march (b,: max over steps and modes of |u|),
    and with a law the dilation, guard flag and guard margin (b,) of the
    μ rows ``mus`` (name → (b,) arrays), all of cell c. With
    ``tf32_products`` (float32 only) every operand of a product is first
    rounded to TF32 (:func:`tf32`) and summed in float32, as TF32
    arithmetic does whatever kernel a library picks for a shape; the
    solve and the sums stay float32."""
    r = tf32 if tf32_products else (lambda x: x)
    cell = cell_parts(payload, c)
    fom, phys = config["fom"], config["physics"]
    nt, nx = int(fom["nt"]), int(fom["nx"])
    dt = float(fom["tf"]) / nt
    mu = {k: _t(v, dtype, device) for k, v in mus.items()}
    b = mu["a0"].shape[0]
    out = {}
    dil = torch.ones(b, dtype=dtype, device=device)
    if cell["law"] is not None:
        dil, oor, margin = dilation(cell["law"], mu)
        out["dil"] = dil
        if oor is not None:
            out["dil_oor"], out["guard_margin"] = oor, margin
    ts = ((torch.arange(nt, dtype=dtype, device=device) + 1) * dt)[:, None]
    ts = ts * dil[None, :]                                        # (nt, b)
    dofs = {name: payload[f"dofs_{name}"] for name in config["sources"]}
    theta = {name: assembly.entries(name, dofs[name], mu, ts, nx,
                                    L0=float(fom["L0"]),
                                    gamma=phys["gamma"],
                                    viscosity=phys["viscosity"])
             for name in config["sources"]}                       # (k,nt,b)
    for name in STIFF_SIDE + ("rhs_vec",):
        theta[name] = theta[name] * dil[None, None, :]
    bL = assembly.piston_fields(mu, ts, float(fom["L0"]),
                                phys["gamma"])["bL"]               # (nt, b)
    b0 = (phys["gamma"] + 1.0) / 2.0 * mu["a0"] * dil              # (b,)

    bounds = cell["bounds"]
    W = len(bounds) - 1
    N = cell["trilinear"].shape[-1]
    u = torch.zeros((b, N), dtype=dtype, device=device)
    u1 = u
    probes = torch.empty((b, nt, 2), dtype=dtype, device=device)
    size = torch.zeros(b, dtype=dtype, device=device)
    for w in range(W):
        lo, hi = int(bounds[w]), int(bounds[w + 1])
        if w > 0:
            T = _t(cell["transfers"][w - 1], dtype, device)
            u, u1 = r(u) @ r(T).T, r(u1) @ r(T).T
        C = {name: _t(cell["combines"][name][w], dtype, device)
             for name in config["sources"]}
        M = torch.einsum("nk,ktb->tbn", r(C["mass"]),
                         r(theta["mass"][:, lo:hi]))
        K = sum(torch.einsum("nk,ktb->tbn", r(C[s]), r(theta[s][:, lo:hi]))
                for s in STIFF_SIDE)
        M = M.reshape(hi - lo, b, N, N)
        K = (dt * K).reshape(hi - lo, b, N, N)
        f = dt * torch.einsum("nk,ktb->tbn", r(C["rhs_vec"]),
                              r(theta["rhs_vec"][:, lo:hi]))
        Tw = _t(cell["trilinear"][w], dtype, device).reshape(N, N, N)
        ends = _t(cell["ends"][w], dtype, device)                  # (2, N)
        for n in range(lo, hi):
            i = n - lo
            if n == 0:
                bdf, comb, ustar = 1.0, u, u
            else:
                bdf, comb, ustar = 1.5, 2.0 * u - 0.5 * u1, 2.0 * u - u1
            Nt = (torch.einsum("ijk,bk->bij", r(Tw), r(ustar))
                  * (dt * b0)[:, None, None])
            A = bdf * M[i] + K[i] + Nt
            rhs = torch.einsum("bij,bj->bi", r(M[i]), r(comb)) + f[i]
            unew = torch.linalg.solve(A, rhs)
            probes[:, n] = r(unew) @ r(ends).T
            size = torch.maximum(size, unew.abs().amax(dim=1))
            u1, u = u, unew
    probes[:, :, 1] += bL.T
    out.update(probes=probes, uN_final=u, state_size=size)
    return out
