"""The reference's paired-LU schedule on the fleet the port builds: where
its follower solves leave the per-step LU, and why.

Builds phase 12's fleet (``chip_smoke.py``: the joint profile's global
build, then ``build_mulocal_serving`` with phase 12's cuts) and, on the
top Mach cell (150x48) and on cell 0 (50x32), each padded to 128 lanes
(cell 5: phase 12 (c)'s batch μ, its 24 training μ and 40 more of its
μ), serves the cell through K1 and compares against the float32 windowed
lanes engine: K1 on the paired schedule (G=5, ``sub1``) and on the
per-step LU, K1 against its twins, and the twin in float64 on both
schedules. Then, stepping the split twin with instruments, at every
follower step: the correction's ratio ‖e‖/‖y‖ (y the substitution with
the leader's factors, e its one refinement), the follower's error
against the step's own LU relative to it, δ/u, and on the top cell
ρ = ‖I − K_lead⁻¹K‖₂; and the sweep with a follower guard that takes the
step's own LU for a lane where ‖e‖/‖y‖ > τ ("ratio") or
‖e‖²/‖y‖ > τ·‖u‖ ("abs"), for a few τ.

Run from the repository root on a machine with a card:
``python3 scripts/paired_lu_probe.py`` (about 8 minutes on an H100);
``--cpu`` runs it on the CPU at a tiny size (nx=100, nt=60, 2x24 cells)
as a rehearsal. Writes ``build/paired_lu_probe.json``.
"""
import argparse
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402
from romtime_tpu_torch.ops import kernel_build  # noqa: E402
from romtime_tpu_torch.ops import windowed_fused as k1  # noqa: E402
from romtime_tpu_torch.ops.compensated import dd_add_small, dd_matvec  # noqa
from romtime_tpu_torch.problems import joint_fleet  # noqa: E402
from romtime_tpu_torch.rom.engines import windowed_fused as eng  # noqa
from romtime_tpu_torch.testing import synthetic as synth  # noqa: E402

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU at a tiny size")
CPU = parser.parse_args().cpu
torch.backends.cuda.matmul.allow_tf32 = False
# Serve on the reference's schedule (the port's default is the per-step
# LU); the per-step LU runs beside it by its explicit option.
os.environ["ROMTIME_PAIRED_LU"] = "5"
OUT = os.path.join(REPO, "build", "paired_lu_probe.json")
T0 = time.perf_counter()


def log(*a):
    print(f"[{time.perf_counter() - T0:7.1f}s]", *a, flush=True)


built = {}
th = threading.Thread(target=lambda: None if CPU else built.update(
    kernel_build.build_all([kernel_build.CSRC / "windowed_serving.cu"])))
th.start()
dev = "cpu" if CPU else "cuda"
power = "cpu" if CPU else cs.card()
if CPU:
    cs.FLEET_BUILD_GRID = {"nx": 100, "nt": 60, "tf": 1.0}
    cs.FLEET_BUILD_CELL_WN = ((2, 24),) * 6
    cs.FLEET_BUILD_B = 512
    for n in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        setattr(torch.cuda, n, lambda *a, **k: None)
log(power)
res = {"card": power}


def lane_norm(v, N):
    return torch.linalg.vector_norm(v[:N].double(), dim=0)


def instrumented(a, kw, guard=None, tau=None, rho_true=False):
    """The twin's split sweep (sub1 G) with diagnostics and an optional
    follower guard: 'ratio' → per-step LU where ‖e‖ > tau·‖y‖."""
    (TH, Bmk, BmF, BkF, Bf, TQ, VE, Tp, b0, state0) = a
    W, width, NP, _km, _kk, period, group = k1._check_args(
        *a, kw["widths"], kw["with_trilinear"], kw["km8"], kw["kk8"],
        kw["kf8"], kw["paired_lu"], kw["paired_mode"], kw["period"],
        kw["n_real"], kw["solve_iters"], kw.get("ablate"))
    N = kw["n_real"]
    km8, kk8, kf8 = kw["km8"], kw["kk8"], kw["kf8"]
    nt, _K8, B = TH.shape
    off_g = km8 + kk8 + kf8
    dtb0 = torch.tensor(kw["dt"], dtype=TH.dtype, device=TH.device) * b0
    roles = k1.step_roles(period, group)
    probes = TH.new_empty((nt, 8, B))
    uN, lo, uN1, lo1 = state0[0], state0[1], state0[2], state0[3]
    stats = []
    nfall = 0
    for w in range(W):
        T = Tp[w]
        uN, lo = dd_matvec(T, uN, lo)
        uN1, lo1 = dd_matvec(T, uN1, lo1)
        consts = (Bmk[w].T, BmF[w].T, BkF[w].T, Bf[w].T)
        pan = None
        for s in range(width):
            step = w * width + s
            tts = TH[step]
            role = roles[s % period]
            pred_hi, pred_lo, d, bdf = k1._dd_predictor(uN, lo, uN1, lo1,
                                                        step, kw["bdf2"])
            KN, r0 = k1.split_build(tts, consts[0], consts[3], pred_hi, d,
                                    bdf, dtb0, NP, BmF.shape[2] // NP,
                                    BkF.shape[2] // NP, km8, kk8, kf8)
            if role == "follow":
                y = k1.panels_substitute(pan, r0, NP)
                resid = r0 - k1.lanes_matvec(KN, y)
                e = k1.panels_substitute(pan, resid, NP)
                delta = y + e
                dlu = k1.lanes_solve_panels(KN, r0, NP)[0]
                ratio = lane_norm(e, N) / lane_norm(y, N).clamp_min(1e-300)
                err = (lane_norm(delta - dlu, N)
                       / lane_norm(dlu, N).clamp_min(1e-300))
                rel_u = lane_norm(dlu, N) / lane_norm(pred_hi, N)
                row = dict(step=step, ratio=float(ratio.max()),
                           err=float(err.max()),
                           worst_lane=int(err.argmax()),
                           ratio_at_worst=float(ratio[err.argmax()]),
                           delta_over_u=float(rel_u.max()))
                if rho_true:
                    R = KN.reshape(NP, NP * B)
                    rep = [(D.repeat(1, 1, NP), U.repeat(1, 1, NP),
                            C.repeat(1, 1, NP)) for D, U, C in pan]
                    X = k1.panels_substitute(rep, R, NP).reshape(NP, NP, B)
                    M = (torch.eye(NP, dtype=X.dtype, device=X.device)
                         [:, :, None] - X)[:N, :N].permute(2, 0, 1).double()
                    fin = torch.isfinite(M).all(dim=(1, 2))
                    rho = torch.full((B,), float("inf"),
                                     dtype=torch.float64, device=M.device)
                    if bool(fin.any()):
                        rho[fin] = torch.linalg.matrix_norm(M[fin], ord=2)
                    row["rho"] = float(rho.max())
                    row["rho_at_worst"] = float(rho[err.argmax()])
                stats.append(row)
                if guard is not None:
                    if guard == "ratio":
                        bad = ratio > tau
                    else:
                        est = lane_norm(e, N) ** 2 / lane_norm(
                            y, N).clamp_min(1e-300)
                        bad = ~(est <= tau * lane_norm(pred_hi, N))
                    if bool(bad.any()):
                        nfall += int(bad.sum())
                        delta = torch.where(bad[None, :], dlu, delta)
            elif role == "lead":
                delta, pan = k1.lanes_solve_panels(KN, r0, NP)
            else:
                delta = k1.lanes_solve(KN, r0, N, NP)
            uN_new, lo_new = dd_add_small(pred_hi, pred_lo, delta)
            probes[step] = VE[w] @ uN_new + tts[off_g:off_g + 8]
            uN1, lo1, uN, lo = uN, lo, uN_new, lo_new
    return probes, stats, nfall


def host(p):
    """(B, nt, 2) float64 from a host result or a kernel's (nt, 8, B)."""
    if isinstance(p, torch.Tensor):
        return p[:, :2].permute(2, 0, 1).double().cpu()
    return torch.as_tensor(np.asarray(p)).double()


def gap(p, q):
    g = (host(p) - host(q)).abs()
    return dict(max=float(g.max()), per_lane=g.amax(dim=(1, 2)).tolist(),
                worst_steps=torch.argsort(g.amax(dim=(0, 2)))[-5:]
                .flip(0).tolist())


with torch.inference_mode():
    workdir = tempfile.mkdtemp()
    hrom, secs, calls = cs.build_pipeline(dev, cs.FLEET_BUILD_GRID, workdir,
                                          profile="joint_profile")
    rom = hrom.rom
    log("global build", secs)
    kwargs = joint_fleet(per_cell=cs.FLEET_BUILD_PER_CELL,
                         register=cs.FLEET_BUILD_REGISTER,
                         cell_wn=cs.FLEET_BUILD_CELL_WN)
    os.chdir(workdir)
    ml = hrom.build_mulocal_serving(device_sweep=True, **kwargs)
    log("fleet build", hrom.fleet_seconds)
    cell = 5
    mus = synth.synthetic_mus(cs.FLEET_BUILD_B, seed=61 + cs.FLEET_CALLS)
    cells = ml.cell_of([rom.compute_piston_mach_number(m) for m in mus])
    sub_c = [dict(mus[int(i)]) for i in np.nonzero(cells == cell)[0]]
    train = [dict(m) for m in hrom.cell_mus[cell]]
    extra = []
    seed = 200
    while len(extra) < 40 and seed < 260:
        ms = synth.synthetic_mus(2048, seed=seed)
        cc = ml.cell_of([rom.compute_piston_mach_number(m) for m in ms])
        extra += [dict(ms[int(i)]) for i in np.nonzero(cc == cell)[0]]
        seed += 1
    extra = extra[:40]
    groups = dict(c_batch=len(sub_c), train=len(train), extra=len(extra))
    lanes_mus = sub_c + train + extra
    lanes_mus = (lanes_mus * 2)[:128]
    res["lane_groups"] = groups
    log("lanes", groups)
    th.join()
    log("kernel built", {str(k): v[1] for k, v in built.items()})

    rom.ONLINE_PRECOMPUTE_BUDGET = 0
    GUARDS = (("ratio", 0.1), ("ratio", 0.01), ("abs", 1e-5), ("abs", 1e-6),
              ("abs", 1e-7))

    def study(cell, lanes_mus, full):
        out = {}
        rom._set_serving_windows(ml.cells[cell])
        cap = {}
        real = eng.online_sweep_windowed_fused

        def spy(*a, **k):
            cap["a"], cap["k"] = a, k
            return real(*a, **k)

        eng.online_sweep_windowed_fused = spy
        served = rom.solve_batch(lanes_mus, mode="probes")
        eng.online_sweep_windowed_fused = real
        a, kw = cap["a"], cap["k"]
        out["kw"] = {k: v for k, v in kw.items() if k != "widths"}
        out["W"] = len(kw["widths"])
        lanes = rom.solve_batch(lanes_mus, mode="probes", engine="windowed")
        L = lanes["probes"]
        out["scale"] = float(np.abs(L).max())
        log(cell, "served + lanes done")
        P_k = k1.online_sweep_windowed_fused(*a, **kw)[0]
        P_klu = k1.online_sweep_windowed_fused(
            *a, **dict(kw, paired_lu=None))[0]
        assert host(served["probes"]).shape == host(P_k).shape
        g = {"served_vs_lanes": gap(served["probes"], L),
             "kernel_sub1_vs_lanes": gap(P_k, L),
             "kernel_lu_vs_lanes": gap(P_klu, L)}
        if full:
            P_t = k1.windowed_fused_reference(*a, **kw)[0]
            P_ts = k1.windowed_fused_reference(*a, **kw, split=True)[0]
            P_tlu = k1.windowed_fused_reference(
                *a, **dict(kw, paired_lu=None), split=True)[0]
            a64 = tuple(t.double() for t in a)
            P_64 = k1.windowed_fused_reference(
                *a64, **dict(kw, paired_lu=None))[0]
            P_64s = k1.windowed_fused_reference(*a64, **kw)[0]
            g.update({
                "kernel_sub1_vs_twin_sub1": gap(P_k, P_t),
                "kernel_sub1_vs_twin_split_sub1": gap(P_k, P_ts),
                "kernel_lu_vs_twin_lu": gap(P_klu, P_tlu),
                "f64_lu_vs_lanes": gap(P_64, L),
                "kernel_sub1_vs_f64_lu": gap(P_k, P_64),
                "kernel_lu_vs_f64_lu": gap(P_klu, P_64),
                "f64_sub1_vs_f64_lu": gap(P_64s, P_64)})
        out["gaps"] = g
        for k, v in g.items():
            log(cell, k, v["max"], "worst steps", v["worst_steps"])
        _, stats, _ = instrumented(a, kw, rho_true=full)
        out["n_follower_steps"] = len(stats)
        out["follower_stats_top"] = sorted(
            stats, key=lambda r: -r["err"])[:40]
        for key in ("ratio", "err", "rho", "delta_over_u"):
            if key in stats[0]:
                out[key + "_quantiles"] = np.nanquantile(
                    [r[key] for r in stats], [0.5, 0.9, 0.99, 1.0]).tolist()
                log(cell, key, out[key + "_quantiles"])
        for r in out["follower_stats_top"][:10]:
            log("  ", r)
        out["guard"] = {}
        for crit, tau in GUARDS:
            P_g, _, nf = instrumented(a, kw, guard=crit, tau=tau)
            gg = gap(P_g, L)
            out["guard"][f"{crit} {tau}"] = dict(
                fallbacks=nf, of=len(stats) * len(lanes_mus),
                gap=gg["max"], worst=gg["worst_steps"])
            log(cell, "guard", crit, tau, "fallback lane-steps", nf, "of",
                len(stats) * len(lanes_mus), "gap", gg["max"],
                "limit", 5e-6 * out["scale"])
        return out

    res["cell5"] = study(5, lanes_mus, True)
    sub0 = [dict(mus[int(i)]) for i in np.nonzero(cells == 0)[0]]
    sub0 = (sub0 * -(-128 // len(sub0)))[:128]
    res["cell0"] = study(0, sub0, False)
os.makedirs(os.path.dirname(OUT), exist_ok=True)
with open(OUT, "w") as f:
    json.dump(res, f, indent=1, default=float)
log("done")
