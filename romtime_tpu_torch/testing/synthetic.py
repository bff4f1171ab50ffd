"""Seeded synthetic serving data for the port (the analog of random-init
weights): K1-K5 kernel inputs at serving shapes, and whole serving cells
(windowed, on a global basis, and the flagship μ-local fleet) on the real
piston FOM.

The synthetic cell has the flagship active-cell shape (W=50 windows of
30 steps, N=32 per window) on the flagship FOM (nx=1000, nt=1500, tf=1.0,
P1). Its interpolation dofs are drawn from the seed (``k`` per θ source)
and its combine tensors follow the reference tests' stable recipe
(tests/test_pallas_online.py ``_windowed_synthetic``): each θ column is
scaled by 1/max_t|θ_k(μ_center, t)|, the mass combine carries the
identity on its first (diagonal, positive) dof, the stiffness combine
carries 2·I on its first (diagonal) dof, and the remaining combines are
small noise. That keeps K = bdf·M + dt·S diagonally dominant, the regime
of the pivot-free LU (``certify_pivot_free`` checks it on a global basis
before the first sweep; the windowed cell carries none, so its check is
skipped, as the reference skips it).

The synthetic fleet (:func:`synthetic_fleet`) is the flagship's six
Mach cells (``bench.py``'s ``cell_wn``: four 50x32 cells and two 150x48
cells) on one FOM and one set of reductors, each cell drawn by the same
recipe, with equal-width Mach edges over the μ box; with ``srom_extra``
each cell is drawn at N+Δ and the serving cell sliced from it, as the
reference nests its S-ROM cells.

The synthetic estimator (:func:`synthetic_estimator`) is the global pair
of ``bench.py``'s throughput profile: an S-ROM at N̂=20 with an
orthonormal basis, each reductor's PᵀU (unit lower triangular, as DEIM's
is) and ``basis_rom``, and the ROM at N=15 as its leading blocks.
"""

import numpy as np
import torch

from ..convert import piston_fom
from ..dtypes import compute_dtype_scope
from ..ops.windowed_fused import PROBE_P, pad_dim
from ..rom.engines.global_fused import GlobalServing
from ..rom.engines.windowed_fused import time_grid
from ..rom.hrom import HyperReducedPiston
from ..rom.registration import DilationLaw
from ..rom.rom import THETA_SOURCES, RomConstructorNonlinear, make_reductors
from ..rom.windowed import MuLocalWindowed, WindowedServing, leading_modes

#: The μ box of the flagship benchmark (a0, ω, δ; α and γ fixed): the
#: ``grid`` of the synthetic serving objects (the pivot-free guard and the
#: auto solve policy probe its corners).
MU_BOX = {"a0": (8.0, 10.0), "omega": (15.0, 20.0), "delta": (0.1, 0.15),
          "alpha": (1e-6, 1e-6), "gamma": (1.4, 1.4)}


def synthetic_mus(B, seed=0):
    """B μ dicts drawn uniformly from :data:`MU_BOX`."""
    rng = np.random.default_rng(seed)
    draws = {k: rng.uniform(lo, hi, size=B) for k, (lo, hi) in MU_BOX.items()}
    return [{k: float(v[b]) for k, v in draws.items()} for b in range(B)]


def mu_center():
    return {k: 0.5 * (lo + hi) for k, (lo, hi) in MU_BOX.items()}


def kernel_tables(N, W, width, B, seed=0, device="cuda",
                  with_trilinear=True, bdf2=True):
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


def resid_tables(N, nt, B, seed=0, device="cuda", theta=False,
                 with_trilinear=True, bdf2=True, step0=0):
    """Inputs of one K2 (``theta=False``) or K3 (``theta=True``) launch of
    ``nt`` steps from global step ``step0``, in the reference layouts on
    ``device`` (float32). The recipe of tests/test_pallas_online.py
    ``test_theta_v2_fori_steps_blocked_gj`` (K = bdf·M + dt·S diagonally
    dominant), with the serving cell's θ row extents (km8=8, kk8=32,
    kf8=8) and the padded identity on a constant-1 θk row; K2 gets the
    same operators materialized (MN = Bm·θm, KL = Bk·θk, fN = Bf·θf).
    With ``step0 > 0`` the carry is a nonzero dd state, as a chained
    launch receives it. Returns (args tuple, keyword dict)."""
    rng = np.random.default_rng(seed)
    km8, kk8, kf8 = 8, 32, 8
    NP = pad_dim(N)
    dt = 1.0 / (step0 + nt)
    idx, pad = np.arange(N), np.arange(N, NP)

    thm = 0.1 * rng.normal(size=(nt, km8, B))
    thm[:, 0] = 1.0 + 0.05 * rng.normal(size=(nt, B))
    thk = 0.1 * rng.normal(size=(nt, kk8, B))
    thk[:, 0] = 1.0 + 0.05 * rng.normal(size=(nt, B))
    thk[:, -1] = 1.0
    thf = rng.normal(size=(nt, kf8, B))
    g = np.zeros((nt, PROBE_P, B))
    g[:, :2] = 0.01 * rng.normal(size=(nt, 2, B))
    Bm = np.zeros((NP, NP, km8))
    Bm[:N, :N] = 0.02 * rng.normal(size=(N, N, km8))
    Bm[idx, idx, 0] += 1.0
    Bk = np.zeros((NP, NP, kk8))
    Bk[:N, :N, :-1] = 0.01 * dt * rng.normal(size=(N, N, kk8 - 1))
    Bk[idx, idx, 0] += 2.0 * dt
    Bk[pad, pad, -1] = 1.0
    Bf = np.zeros((NP, kf8))
    Bf[:N] = 0.1 * dt * rng.normal(size=(N, kf8))
    T0 = np.zeros((NP, NP, NP))
    T0[:N, :N, :N] = 0.02 * rng.normal(size=(N, N, N))
    VE = np.zeros((PROBE_P, NP))
    VE[:2, :N] = rng.normal(size=(2, N))
    b0 = 1.0 + 0.1 * rng.normal(size=(1, B))
    state0 = np.zeros((4, NP, B))
    if step0 > 0:
        u = 0.1 * rng.normal(size=(N, B))
        for r, v in ((0, u), (2, u - 1e-3 * rng.normal(size=(N, B)))):
            hi = v.astype(np.float32)
            state0[r, :N] = hi
            state0[r + 1, :N] = (v - hi).astype(np.float32)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=device)

    Bm, Bk = dev(Bm.reshape(NP * NP, km8)), dev(Bk.reshape(NP * NP, kk8))
    THm, THk, THf, Bf = dev(thm), dev(thk), dev(thf), dev(Bf)
    tail = (dev(T0.reshape(NP * NP, NP)), dev(VE), dev(b0), dev(state0))
    kw = dict(dt=dt, step0=step0, bdf2=bdf2, with_trilinear=with_trilinear,
              n_real=N)
    if theta:
        return (THm, THk, THf, dev(g), Bm, Bk, Bf) + tail, kw
    MN, KL = (torch.einsum("nk,tkB->tnB", C, th).reshape(nt, NP, NP, B)
              .contiguous() for C, th in ((Bm, THm), (Bk, THk)))
    fN = torch.einsum("nk,tkB->tnB", Bf, THf).contiguous()
    return (MN, KL, fN, dev(g)) + tail, kw


def _draw_dofs(rng, nh, k, matrix):
    rows = rng.choice(np.arange(1, nh - 1), size=k, replace=False)
    if not matrix:
        return rows[:, None]
    cols = rows + rng.integers(-1, 2, size=k)
    cols[0] = rows[0]                      # first entry on the diagonal
    return np.stack([rows, cols], axis=1)


def _base_parts(rng, nx, nt, tf, k):
    """FOM, reductors (their dofs drawn from ``rng``) and the θ scales of
    the combine recipe (see the module doc)."""
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
    return fom, reductors, scales


def _draw_combines(rng, scales, W, N, k):
    """(W, n_out, k) combines of a seeded cell, drawn from ``rng``."""
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
    return combines


def _draw_windows(rng, nh, nt, scales, W, N, k):
    """A seeded :class:`WindowedServing` of W equal windows at N: the
    combines, the bases' end rows, orthogonal transfers and the trilinear
    term, drawn from ``rng`` in that order."""
    combines = _draw_combines(rng, scales, W, N, k)
    Vs = np.zeros((W, nh, N))
    Vs[:, [0, -1], :] = rng.normal(size=(W, 2, N))
    transfers = np.stack([np.linalg.qr(rng.normal(size=(N, N)))[0]
                          for _ in range(W - 1)])
    return WindowedServing(
        bounds=np.linspace(0, nt, W + 1).astype(int), Vs=Vs,
        transfers=transfers, combines=combines,
        trilinear=0.02 * rng.normal(size=(W, N * N, N)),
    )


def synthetic_cell(seed=0, nx=1000, nt=1500, tf=1.0, n_windows=50, N=32,
                   k=8, device="cuda"):
    """A seeded windowed serving cell on the real piston FOM (see module
    doc)."""
    rng = np.random.default_rng(seed)
    fom, reductors, scales = _base_parts(rng, nx, nt, tf, k)
    win = _draw_windows(rng, fom.mesh.nh, nt, scales, n_windows, N, k)
    return RomConstructorNonlinear.from_artifacts(fom, reductors, win,
                                                  device=device, grid=MU_BOX)


#: The flagship fleet's cell shapes (W, N), ``bench.py``'s
#: ``cell_wn="50x32,50x32,50x32,50x32,150x48,150x48"``.
FLEET_CELL_WN = ((50, 32),) * 4 + ((150, 48),) * 2


def _draw_law(rng):
    """A seeded guarded dilation law in a0: d(μ) = 1 + s·(a0 − 9) with s
    in [0.002, 0.006], the guard's training cloud six a0 values across the
    box (range-normalized), its fill distance 0.08."""
    s = rng.uniform(0.002, 0.006)
    lo, hi = MU_BOX["a0"]
    return DilationLaw(
        names=("a0",), coef=np.array([1.0 - 9.0 * s, s]), floor=0.9,
        guard_feats=rng.uniform(lo, hi, size=(6, 1)) / (hi - lo),
        guard_inv_span=np.array([1.0 / (hi - lo)]), guard_dref=0.08)


def synthetic_fleet(cell_wn=FLEET_CELL_WN, register=(5,), seed=0, nx=1000,
                    nt=1500, tf=1.0, k=8, device="cuda", srom_extra=None):
    """A seeded μ-local fleet on the real piston FOM: one FOM and one set
    of reductors (dofs drawn once), one cell per (W, N) of ``cell_wn``
    drawn by :func:`synthetic_cell`'s recipe, equal-width Mach edges over
    :data:`MU_BOX`, and a seeded guarded dilation law on each cell of
    ``register``. With ``srom_extra`` = Δ (``bench.py``'s default is 8)
    each cell is drawn at (W, N+Δ), kept as the fleet's nested S-ROM cell
    (``cells_srom``), and the serving cell is its
    :meth:`~romtime_tpu_torch.rom.windowed.WindowedServing.truncate` to
    N. Returns the serving object with the fleet attached as ``mulocal``
    and cell 0 active."""
    rng = np.random.default_rng(seed)
    fom, reductors, scales = _base_parts(rng, nx, nt, tf, k)
    extra = srom_extra or 0
    drawn = [_draw_windows(rng, fom.mesh.nh, nt, scales, W, N + extra, k)
             for W, N in cell_wn]
    for c in register:
        drawn[c].dilation = _draw_law(rng)
    cells, cells_srom = drawn, None
    if srom_extra:
        cells = [w.truncate(N) for w, (_W, N) in zip(drawn, cell_wn)]
        cells_srom = drawn
    edges = RomConstructorNonlinear.compute_piston_mach_number_space(
        MU_BOX, len(cells))
    rom = RomConstructorNonlinear.from_artifacts(
        fom, reductors, cells[0], device=device, grid=MU_BOX)
    rom.mulocal = MuLocalWindowed(edges=edges, cells=cells,
                                  cells_srom=cells_srom)
    return rom


def synthetic_global_cell(N=15, k=8, nx=1000, nt=1500, seed=0,
                          device="cuda"):
    """A seeded global-basis serving cell (``engine="pallas"``) on the
    real piston FOM: the one-window case of :func:`synthetic_cell`'s
    recipe, with the global basis's end rows and the trilinear state
    table drawn from the seed."""
    rng = np.random.default_rng(seed)
    fom, reductors, scales = _base_parts(rng, nx, nt, 1.0, k)
    combines = _draw_combines(rng, scales, 1, N, k)
    basis = np.zeros((fom.mesh.nh, N))
    basis[[0, -1], :] = rng.normal(size=(2, N))
    gs = GlobalServing(basis=basis,
                       combines={n: C[0] for n, C in combines.items()},
                       trilinear=0.02 * rng.normal(size=(N * N, N)))
    return RomConstructorNonlinear.from_artifacts(
        fom, reductors, device=device, global_serving=gs, grid=MU_BOX)


def synthetic_estimator(N=15, N_hat=20, k=8, nx=1000, nt=1500, seed=0,
                        device="cuda"):
    """A seeded global S-ROM estimator on the real piston FOM
    (:class:`~romtime_tpu_torch.rom.hrom.HyperReducedPiston` with ``rom``
    and ``srom``): the S-ROM drawn at ``N_hat`` by
    :func:`synthetic_global_cell`'s recipe with an orthonormal basis (the
    estimator's coefficient norm is the reconstruction norm only then),
    a well-conditioned unit lower triangular ``PT_U`` per source,
    ``basis_rom`` = folded·PᵀU and the folded combine reset to
    basis_rom·(PᵀU)⁻¹ in float64, so that the float32 and float64 forms
    describe one operator; the ROM at ``N`` takes the leading blocks of
    the basis, of ``basis_rom``, of the folded combines and of the
    trilinear table, and shares the dofs and PᵀU."""
    rng = np.random.default_rng(seed)
    fom, base, scales = _base_parts(rng, nx, nt, 1.0, k)
    dofs = {name: red.dofs_array() for name, red in base.items()}
    folded = _draw_combines(rng, scales, 1, N_hat, k)
    PT_U, basis_rom, combines = {}, {}, {}
    for name in THETA_SOURCES:
        P = np.eye(k) + np.tril(0.2 * rng.normal(size=(k, k)), -1)
        PT_U[name] = P
        basis_rom[name] = folded[name][0] @ P
        combines[name] = basis_rom[name] @ np.linalg.inv(P)
    basis = np.linalg.qr(rng.normal(size=(fom.mesh.nh, N_hat)))[0]
    tri = 0.02 * rng.normal(size=(N_hat * N_hat, N_hat))

    def serving(n):
        lead = {name: {"PT_U": PT_U[name],
                       "basis_rom": leading_modes(basis_rom[name], n,
                                                  N_hat)}
                for name in THETA_SOURCES}
        gs = GlobalServing(
            basis=np.ascontiguousarray(basis[:, :n]),
            combines={name: leading_modes(C, n, N_hat)
                      for name, C in combines.items()},
            trilinear=np.ascontiguousarray(
                tri.reshape(N_hat, N_hat, N_hat)[:n, :n, :n]
                .reshape(n * n, n)))
        return RomConstructorNonlinear.from_artifacts(
            fom, make_reductors(fom, dofs, lead), device=device,
            global_serving=gs, grid=MU_BOX)

    return HyperReducedPiston.from_serving(serving(N), srom=serving(N_hat))


def certification_mus(n_held_out=15, seed=7):
    """The certification batch: ``n_held_out`` μ drawn from
    :data:`MU_BOX` and the box center, last."""
    return synthetic_mus(n_held_out, seed=seed) + [mu_center()]


def global_tables(N, nt, B, seed=0, device="cuda", theta=False,
                  with_trilinear=True, bdf2=True):
    """Inputs of one K4 (``theta=False``) or K5 (``theta=True``) sweep in
    the reference layouts on ``device`` (float32). The recipe of
    tests/test_pallas_online.py ``_synthetic`` (MN ≈ I + noise,
    KL ≈ (2·I + noise)·dt, fN ≈ 0.1·dt·noise, T0 = 0.05·noise,
    b0 ≈ 1 + noise), in the θ-factored form of :func:`resid_tables`
    (km8=8, kk8=32, kf8=8, the padded identity on a constant-1 θk row),
    since full-size tables cannot be factored at k = N² as that test
    does; K4 gets the same operators materialized (MN = Bm·θm,
    KL = Bk·θk, fN = Bf·θf). The θ streams are drawn on ``device``.
    Returns (args tuple, keyword dict)."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    km8, kk8, kf8 = 8, 32, 8
    NP = pad_dim(N)
    dt = 1.0 / nt
    idx, pad = np.arange(N), np.arange(N, NP)

    def noise(*shape):
        return torch.randn(shape, generator=gen, device=device)

    THm = 0.1 * noise(nt, km8, B)
    THm[:, 0] = 1.0 + 0.05 * noise(nt, B)
    THk = 0.1 * noise(nt, kk8, B)
    THk[:, 0] = 1.0 + 0.05 * noise(nt, B)
    THk[:, -1] = 1.0
    THf = noise(nt, kf8, B)
    g = torch.zeros((nt, PROBE_P, B), device=device)
    g[:, :2] = 0.01 * noise(nt, 2, B)
    # Noise shrinks as 1/sqrt(N) past N=15 (the recipe's largest N), so
    # that MN stays diagonally dominant near the top of the gate (N=64).
    damp = 1.0 / max(1.0, np.sqrt(N / 15))
    Bm = np.zeros((NP, NP, km8))
    Bm[:N, :N] = 0.05 * damp * rng.normal(size=(N, N, km8))
    Bm[idx, idx, 0] += 1.0
    Bk = np.zeros((NP, NP, kk8))
    Bk[:N, :N, :-1] = 0.02 * damp * dt * rng.normal(size=(N, N, kk8 - 1))
    Bk[idx, idx, 0] += 2.0 * dt
    Bk[pad, pad, -1] = 1.0
    Bf = np.zeros((NP, kf8))
    Bf[:N] = 0.1 * dt * rng.normal(size=(N, kf8))
    T0 = np.zeros((NP, NP, NP))
    T0[:N, :N, :N] = 0.05 * damp * rng.normal(size=(N, N, N))
    VE = np.zeros((PROBE_P, NP))
    VE[:2, :N] = rng.normal(size=(2, N))
    b0 = 1.0 + 0.1 * rng.normal(size=(1, B))

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=device)

    Bm, Bk = dev(Bm.reshape(NP * NP, km8)), dev(Bk.reshape(NP * NP, kk8))
    Bf = dev(Bf)
    tail = (dev(T0.reshape(NP * NP, NP)), dev(VE), dev(b0))
    kw = dict(dt=dt, bdf2=bdf2, with_trilinear=with_trilinear, n_real=N)
    if theta:
        return (THm, THk, THf, g, Bm, Bk, Bf) + tail, kw
    MN, KL = (torch.einsum("nk,tkB->tnB", C, th).reshape(nt, NP, NP, B)
              .contiguous() for C, th in ((Bm, THm), (Bk, THk)))
    fN = torch.einsum("nk,tkB->tnB", Bf, THf).contiguous()
    return (MN, KL, fN, g) + tail, kw
