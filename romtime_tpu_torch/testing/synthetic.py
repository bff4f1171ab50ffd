"""Seeded synthetic serving data for the port (the analog of random-init
weights): K1 kernel tables at serving shapes, and a whole serving cell on
the real piston FOM.

The synthetic cell has the flagship active-cell shape (W=50 windows of
30 steps, N=32 per window) on the flagship FOM (nx=1000, nt=1500, tf=1.0,
P1). Its interpolation dofs are drawn from the seed (``k`` per θ source)
and its combine tensors follow the reference tests' stable recipe
(tests/test_pallas_online.py ``_windowed_synthetic``): each θ column is
scaled by 1/max_t|θ_k(μ_center, t)|, the mass combine carries the
identity on its first (diagonal, positive) dof, the stiffness combine
carries 2·I on its first (diagonal) dof, and the remaining combines are
small noise. That keeps K = bdf·M + dt·S diagonally dominant, the regime
of the pivot-free LU (``certify_pivot_free`` checks it before a sweep).
"""

import numpy as np
import torch

from ..convert import piston_fom
from ..dtypes import compute_dtype_scope
from ..ops.windowed_fused import PROBE_P, pad_dim
from ..rom.engines.windowed_fused import time_grid
from ..rom.rom import THETA_SOURCES, RomConstructorNonlinear, make_reductors
from ..rom.windowed import WindowedServing

#: The μ box of the flagship benchmark (a0, ω, δ; α and γ fixed).
MU_BOX = {"a0": (8.0, 10.0), "omega": (15.0, 20.0), "delta": (0.1, 0.15),
          "alpha": (1e-6, 1e-6), "gamma": (1.4, 1.4)}


def synthetic_mus(B, seed=0):
    """B μ dicts drawn uniformly from :data:`MU_BOX`."""
    rng = np.random.default_rng(seed)
    draws = {k: rng.uniform(lo, hi, size=B) for k, (lo, hi) in MU_BOX.items()}
    return [{k: float(v[b]) for k, v in draws.items()} for b in range(B)]


def mu_center():
    return {k: 0.5 * (lo + hi) for k, (lo, hi) in MU_BOX.items()}


def kernel_tables(N, W, width, B, seed=0, device="cpu", with_trilinear=True,
                  bdf2=True):
    """K1 inputs in the reference layouts on ``device`` (float32):
    the recipe of tests/test_pallas_online.py ``_windowed_synthetic`` with
    θ streams damped to a smooth ~0.5%-per-step drift (the paired-LU
    regime). Returns (args tuple, keyword dict)."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    km8, kk8, kf8 = 8, 16, 8
    NP = pad_dim(N)
    nt = W * width
    dt = 1.0 / nt

    def noise(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def smooth(th):
        m = th.mean(dim=0, keepdim=True)
        return m + 0.05 * (th - m)

    thm = 0.1 * noise(nt, km8, B)
    thm[:, 0] = 1.0 + 0.05 * noise(nt, B)
    thk = 0.1 * noise(nt, kk8, B)
    thk[:, 0] = 1.0 + 0.05 * noise(nt, B)
    thf = noise(nt, kf8, B)
    g = torch.zeros((nt, PROBE_P, B), device=device)
    g[:, :2] = 0.01 * noise(nt, 2, B)
    TH = torch.cat([smooth(thm), smooth(thk), smooth(thf), g], dim=1)

    Bm = np.zeros((W, NP, NP, km8), np.float32)
    Bk = np.zeros((W, NP, NP, kk8), np.float32)
    Bf = np.zeros((W, NP, kf8), np.float32)
    T0 = np.zeros((W, NP, NP, NP), np.float32)
    VE = np.zeros((W, PROBE_P, NP), np.float32)
    Tp = np.zeros((W, NP, NP), np.float32)
    Tp[0, :N, :N] = np.eye(N)
    idx = np.arange(N)
    Bm[:, :N, :N] = 0.02 * rng.normal(size=(W, N, N, km8)) / np.sqrt(N / 12)
    Bm[:, idx, idx, 0] += 1.0
    Bk[:, :N, :N] = 0.01 * dt * rng.normal(size=(W, N, N, kk8))
    Bk[:, idx, idx, 0] += 2.0 * dt
    Bk[:, np.arange(N, NP), np.arange(N, NP), 0] = 1.0
    Bf[:, :N] = 0.1 * dt * rng.normal(size=(W, N, kf8))
    T0[:, :N, :N, :N] = 0.02 * rng.normal(size=(W, N, N, N))
    VE[:, :2, :N] = rng.normal(size=(W, 2, N))
    for w in range(1, W):
        Tp[w, :N, :N] = np.linalg.qr(rng.normal(size=(N, N)))[0]
    Bm = Bm.reshape(W, NP * NP, km8)
    Bk = Bk.reshape(W, NP * NP, kk8)
    T0 = T0.reshape(W, NP * NP, NP)
    BmF = (Bm.reshape(W, NP, NP, km8).transpose(0, 3, 1, 2)
           .reshape(W, km8 * NP, NP))
    BkF = (Bk.reshape(W, NP, NP, kk8).transpose(0, 3, 1, 2)
           .reshape(W, kk8 * NP, NP))
    b0 = (1.0 + 0.1 * rng.normal(size=(1, B))).astype(np.float32)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=device)

    folded = [Bm, Bk] + ([T0] if with_trilinear else [])
    args = (TH.contiguous(), dev(np.concatenate(folded, axis=2)
                                 .transpose(0, 2, 1)),
            dev(BmF.transpose(0, 2, 1)), dev(BkF.transpose(0, 2, 1)),
            dev(Bf.transpose(0, 2, 1)), dev(T0.reshape(W, NP, NP * NP)),
            dev(VE), dev(Tp), dev(b0),
            torch.zeros((4, NP, B), device=device))
    kw = dict(widths=(width,) * W, dt=dt, bdf2=bdf2,
              with_trilinear=with_trilinear, n_real=N, km8=km8, kk8=kk8,
              kf8=kf8)
    return args, kw


def _draw_dofs(rng, nh, k, matrix):
    rows = rng.choice(np.arange(1, nh - 1), size=k, replace=False)
    if not matrix:
        return rows[:, None]
    cols = rows + rng.integers(-1, 2, size=k)
    cols[0] = rows[0]                      # first entry on the diagonal
    return np.stack([rows, cols], axis=1)


def synthetic_cell(seed=0, nx=1000, nt=1500, tf=1.0, n_windows=50, N=32,
                   k=8, device="cpu"):
    """A seeded serving cell on the real piston FOM (see module doc)."""
    rng = np.random.default_rng(seed)
    fom = piston_fom(L0=1.0, nx=nx, tf=tf, nt=nt)
    nh = fom.mesh.nh
    dofs = {name: _draw_dofs(rng, nh, k, matrix=name != "rhs_vec")
            for name in THETA_SOURCES}
    reductors = make_reductors(fom, dofs)

    # θ scales at the box center over the whole time grid (float64).
    with compute_dtype_scope(torch.float64):
        mu = {key: torch.tensor([v], dtype=torch.float64)
              for key, v in mu_center().items()}
        ts = time_grid(fom, None, torch.float64, "cpu")[:, None]
        scales = {name: red._entries_traced(mu, ts).abs().amax(dim=(1, 2))
                  .clamp(min=1e-300).numpy()
                  for name, red in reductors.items()}

    W = n_windows
    idx = np.arange(N)
    combines = {}
    for name in THETA_SOURCES:
        inv = 1.0 / scales[name]
        if name == "rhs_vec":
            combines[name] = 0.1 * rng.normal(size=(W, N, k)) * inv
            continue
        C = rng.normal(size=(W, N, N, k))
        C *= 0.005 if name == "mass" else 0.01
        if name == "mass":
            C[:, idx, idx, 0] += 1.0
        elif name == "stiffness":
            C[:, idx, idx, 0] += 2.0
        combines[name] = (C * inv).reshape(W, N * N, k)
    Vs = np.zeros((W, nh, N))
    Vs[:, [0, -1], :] = rng.normal(size=(W, 2, N))
    transfers = np.stack([np.linalg.qr(rng.normal(size=(N, N)))[0]
                          for _ in range(W - 1)])
    win = WindowedServing(
        bounds=np.linspace(0, nt, W + 1).astype(int), Vs=Vs,
        transfers=transfers, combines=combines,
        trilinear=0.02 * rng.normal(size=(W, N * N, N)),
    )
    return RomConstructorNonlinear(fom, reductors, win, device=device)
