"""K1-K5 on the card against their plain PyTorch twins on the card (K1
in both of its designs: the serving design csrc/windowed_serving.cu on
the serving options, the first design csrc/windowed_fused.cu on every
option; K2-K5 in both of theirs: the serving body,
csrc/resid_tables_serving.cu, csrc/windowed_serving.cu,
csrc/global_tables_serving.cu and csrc/global_serving.cu, and the first
designs csrc/resid_sweep.cu and csrc/global_sweep.cu, each against the
op-for-op twin, the split twin and the other design), and the
certification path on the card (phase 9 of chip_smoke.py at a small
size: the global lanes engine against the served K4 and K5, the S-ROM
estimators and the chained lanes variant in float64 against an explicit
CPU run), and the piston FOM sweep on the card (``solve_fom_batch``,
plain and dd, BDF-2 and BDF-1, in float64 against the same sweep on the
CPU; ``solve()`` against its batch row; the float32 sweeps within the
reference's dd limits), the offline build on the card against the
same build on the CPU (``HyperReducedPiston`` at nx=200, nt=300), and
the registered fleet build on the card against the same build on the
CPU (the conftest-size pipeline, nx=150, nt=96), served through K1.
Needs a CUDA device and nvcc; skips without a device. Imports no JAX, so
it runs on a machine without it (tests/conftest.py imports JAX,
hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from romtime_tpu_torch.ops import global_sweep as gs
from romtime_tpu_torch.ops import resid_sweep as rs
from romtime_tpu_torch.ops import windowed_fused as k1
from romtime_tpu_torch.testing.synthetic import (
    certification_mus,
    global_tables,
    kernel_tables,
    resid_tables,
    synthetic_cell,
    synthetic_estimator,
    synthetic_fleet,
    synthetic_mus,
)

#: (N, W, width, B, paired-LU group, options): Gauss-Jordan-sized and
#: blocked-LU sizes, a ragged lane tile (B not a multiple of the tile),
#: grouping, no trilinear term, BDF-1.
CASES = [(12, 3, 8, 128, None, {}), (24, 3, 8, 130, None, {}),
         (24, 3, 8, 128, 5, {}), (32, 2, 30, 67, 5, {}),
         (48, 2, 10, 40, 5, {}), (24, 3, 8, 64, 5, {"with_trilinear": False}),
         (16, 2, 8, 64, None, {"bdf2": False})]


@pytest.mark.cuda
@pytest.mark.parametrize("N,W,width,B,group,options", CASES)
def test_cuda_kernel_matches_twin(N, W, width, B, group, options):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args, kw = kernel_tables(N, W, width, B, seed=N, device="cuda",
                             **options)
    kw.update(paired_lu=group)
    twin_p, twin_s = k1.windowed_fused_reference(*args, **kw)
    n0 = k1.online_sweep_windowed_fused.launches
    got_p, got_s = k1.online_sweep_windowed_fused(*args, **kw)
    torch.cuda.synchronize()
    assert k1.online_sweep_windowed_fused.launches == n0 + 1
    assert torch.isfinite(got_p).all() and torch.isfinite(got_s).all()
    scale = twin_p.abs().max().item()
    assert (got_p - twin_p).abs().max().item() <= 5e-5 * scale
    sscale = twin_s[[0, 2]].abs().max().item()
    assert (got_s - twin_s)[[0, 2]].abs().max().item() <= 5e-5 * sscale


def _held_to(got, want):
    got_p, got_s = got
    want_p, want_s = want
    assert torch.isfinite(got_p).all() and torch.isfinite(got_s).all()
    scale = want_p.abs().max().item()
    assert (got_p - want_p).abs().max().item() <= 5e-5 * scale
    sscale = want_s[[0, 2]].abs().max().item()
    assert (got_s - want_s)[[0, 2]].abs().max().item() <= 5e-5 * sscale


#: K1's serving-option cases for both designs: CASES, NP=64 (two warps a
#: lane in the serving design, four lanes a block) with and without
#: pairing, and NP=40 and NP=8.
DESIGN_CASES = CASES + [(60, 2, 8, 40, 5, {}), (64, 2, 8, 33, None, {}),
                        (40, 2, 10, 70, 5, {}), (8, 2, 8, 33, None, {})]


@pytest.mark.cuda
@pytest.mark.parametrize("solve_iters", [None, 5], ids=["lu", "richardson"])
@pytest.mark.parametrize("design", ["serving", "first"])
@pytest.mark.parametrize("N,W,width,B,group,options", DESIGN_CASES)
def test_cuda_designs_match_twin(N, W, width, B, group, options, design,
                                 solve_iters):
    """Each K1 design on the serving options (per-step LU, paired LU with
    sub1 followers, Richardson) against the twin; the serving design
    through the wrapper, the first through its private entry."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args, kw = kernel_tables(N, W, width, B, seed=N + 1, device="cuda",
                             **options)
    kw.update(paired_lu=group, solve_iters=solve_iters)
    want = k1.windowed_fused_reference(*args, **kw)
    sweep = (k1.online_sweep_windowed_fused if design == "serving"
             else k1._first_design_sweep)
    _held_to(sweep(*args, **kw), want)


@pytest.mark.cuda
def test_cuda_launch_counters_follow_the_routing_rule():
    """The serving options launch the serving design and only it; the
    other follower modes and the ablations launch the first design."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args, kw = kernel_tables(24, 2, 8, 64, seed=3, device="cuda")
    wrapper = k1.online_sweep_windowed_fused
    for opts, design in (({"paired_lu": None}, "serving"),
                         ({"paired_lu": 5}, "serving"),
                         ({"paired_lu": 5, "solve_iters": 5}, "serving"),
                         ({"paired_lu": 5, "paired_mode": "warm2",
                           "solve_iters": 5}, "serving"),
                         ({"paired_lu": 5, "paired_mode": "inv1"}, "first"),
                         ({"ablate": "no_dots"}, "first"),
                         ({"ablate": "empty", "solve_iters": 5}, "first")):
        before = (wrapper.serving_launches, wrapper.first_design_launches)
        wrapper(*args, **dict(kw, **opts))
        torch.cuda.synchronize()
        after = (wrapper.serving_launches, wrapper.first_design_launches)
        moved = tuple(b - a for a, b in zip(before, after))
        assert moved == ((1, 0) if design == "serving" else (0, 1)), opts


@pytest.mark.cuda
def test_cuda_serving_clocks_match_plain():
    """The CLOCKED instantiation computes what the plain one computes and
    reports a positive cycle count for every block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args, kw = kernel_tables(32, 2, 30, 67, seed=4, device="cuda")
    kw.update(paired_lu=5)
    plain = k1.online_sweep_windowed_fused(*args, **kw)
    p, s, clk = k1._serving_sweep_clocked(*args, **kw)
    torch.cuda.synchronize()
    _held_to((p, s), plain)
    assert clk.shape[1] == len(k1.SERVING_PHASES) + 1
    assert (clk[:, -1] > 0).all()
    assert (clk[:, :-1].sum(dim=1) <= clk[:, -1]).all()


#: (N, W, width, B, solve_iters) of K1's Richardson solve: Gauss-Jordan-
#: and blocked-LU-sized N (paired LU G=5 requested: Richardson takes
#: precedence), a ragged lane tile, on the damped tables of kernel_tables.
RICHARDSON_CASES = [(12, 3, 8, 128, 3), (12, 3, 8, 130, 6),
                    (24, 3, 8, 128, 3), (24, 3, 8, 67, 6)]


@pytest.mark.cuda
@pytest.mark.parametrize("N,W,width,B,iters", RICHARDSON_CASES)
def test_cuda_kernel_richardson_matches_twin(N, W, width, B, iters):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args, kw = kernel_tables(N, W, width, B, seed=N + iters, device="cuda")
    kw.update(paired_lu=5, solve_iters=iters)
    twin_p, twin_s = k1.windowed_fused_reference(*args, **kw)
    n0 = k1.online_sweep_windowed_fused.launches
    r0 = k1.online_sweep_windowed_fused.richardson_launches
    got_p, got_s = k1.online_sweep_windowed_fused(*args, **kw)
    torch.cuda.synchronize()
    assert k1.online_sweep_windowed_fused.launches == n0 + 1
    assert k1.online_sweep_windowed_fused.richardson_launches == r0 + 1
    assert torch.isfinite(got_p).all() and torch.isfinite(got_s).all()
    scale = twin_p.abs().max().item()
    assert (got_p - twin_p).abs().max().item() <= 5e-5 * scale
    sscale = twin_s[[0, 2]].abs().max().item()
    assert (got_s - twin_s)[[0, 2]].abs().max().item() <= 5e-5 * sscale


def _k1_matches_twin(args, kw):
    twin_p, twin_s = k1.windowed_fused_reference(*args, **kw)
    n0 = k1.online_sweep_windowed_fused.launches
    got_p, got_s = k1.online_sweep_windowed_fused(*args, **kw)
    torch.cuda.synchronize()
    assert k1.online_sweep_windowed_fused.launches == n0 + 1
    assert torch.isfinite(got_p).all() and torch.isfinite(got_s).all()
    scale = twin_p.abs().max().item()
    assert (got_p - twin_p).abs().max().item() <= 5e-5 * scale
    sscale = twin_s[[0, 2]].abs().max().item()
    assert (got_s - twin_s)[[0, 2]].abs().max().item() <= 5e-5 * sscale


#: (N, W, width, B, group, mode): every paired-LU follower mode at G=3
#: and G=5 (width ≥ G+2, so followers run), a ragged lane tile, and
#: NP=48 (8-lane tiles, two rows a thread).
MODE_CASES = ([(24, 3, 8, 128, 3, m) for m in k1.PAIRED_MODES[1:]]
              + [(24, 3, 8, 67, 5, m) for m in k1.PAIRED_MODES[1:]]
              + [(48, 2, 10, 40, 3, "warmx"), (48, 2, 10, 40, 3, "inv2")])


@pytest.mark.cuda
@pytest.mark.parametrize("N,W,width,B,group,mode", MODE_CASES)
def test_cuda_kernel_follower_modes_match_twin(N, W, width, B, group, mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args, kw = kernel_tables(N, W, width, B, seed=N + group, device="cuda")
    kw.update(paired_lu=group, paired_mode=mode)
    _k1_matches_twin(args, kw)


#: (N, B, ablate, solve_iters): each ablation with the LU schedule and
#: with the Richardson solve, at a Gauss-Jordan size with a ragged batch
#: and at the 50x32 fleet width.
ABLATE_CASES = [(N, Bn, ablate, iters) for ablate in k1.ABLATE_MODES
                for iters in (None, 5) for N, Bn in ((12, 130), (32, 67))]


@pytest.mark.cuda
@pytest.mark.parametrize("N,B,ablate,iters", ABLATE_CASES)
def test_cuda_kernel_ablate_matches_twin(N, B, ablate, iters):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args, kw = kernel_tables(N, 3, 8, B, seed=N, device="cuda")
    kw.update(paired_lu=5, ablate=ablate, solve_iters=iters)
    _k1_matches_twin(args, kw)


#: (N, nt, B, step0, options) for K2 and K3: Gauss-Jordan and blocked-LU
#: sizes, ragged batches (B not a multiple of any lane tile), a chained
#: launch (step0 > 0 from a nonzero carry), no trilinear term, BDF-1.
RESID_CASES = [(12, 8, 130, 0, {}), (24, 8, 67, 0, {}), (32, 30, 512, 30, {}),
               (48, 10, 40, 20, {}), (24, 8, 64, 8, {"with_trilinear": False}),
               (16, 8, 64, 0, {"bdf2": False}), (12, 6, 5, 3, {})]


@pytest.mark.cuda
@pytest.mark.parametrize("theta", [False, True], ids=["k2", "k3"])
@pytest.mark.parametrize("N,nt,B,step0,options", RESID_CASES)
def test_cuda_resid_kernels_match_twins(N, nt, B, step0, options, theta):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args, kw = resid_tables(N, nt, B, seed=N + step0, device="cuda",
                            theta=theta, step0=step0, **options)
    wrapper, twin = ((rs.online_sweep_theta_pallas_v2,
                      rs.theta_sweep_v2_reference) if theta else
                     (rs.online_sweep_pallas_v2, rs.sweep_v2_reference))
    twin_p, twin_s = twin(*args, **kw)
    n0 = wrapper.launches
    got_p, got_s = wrapper(*args, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == n0 + 1
    assert torch.isfinite(got_p).all() and torch.isfinite(got_s).all()
    scale = twin_p.abs().max().item()
    assert (got_p - twin_p).abs().max().item() <= 5e-5 * scale
    sscale = twin_s[[0, 2]].abs().max().item()
    assert (got_s - twin_s)[[0, 2]].abs().max().item() <= 5e-5 * sscale


#: (N, nt, B, options) for K4 and K5: N=9 (BDF-1 without the trilinear
#: term, the heat-family case, as well as BDF-2 with it), N=15 and N=20
#: (the throughput ROM and S-ROM), a batch that is not a multiple of 128
#: (nor of any lane tile), and N=60 (NP=64, the top of the gate).
NO_TRI_BDF1 = {"bdf2": False, "with_trilinear": False}
GLOBAL_CASES = [(9, 16, 128, {}), (9, 16, 128, NO_TRI_BDF1),
                (15, 24, 256, {}), (15, 24, 256, NO_TRI_BDF1),
                (20, 24, 130, {}), (20, 24, 130, NO_TRI_BDF1),
                (60, 8, 40, {})]


@pytest.mark.cuda
@pytest.mark.parametrize("theta", [False, True], ids=["k4", "k5"])
@pytest.mark.parametrize("N,nt,B,options", GLOBAL_CASES)
def test_cuda_global_kernels_match_twins(N, nt, B, options, theta):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args, kw = global_tables(N, nt, B, seed=N, device="cuda", theta=theta,
                             **options)
    wrapper, twin = ((gs.online_sweep_theta_pallas,
                      gs.theta_sweep_reference) if theta else
                     (gs.online_sweep_pallas, gs.sweep_reference))
    twin_p, twin_u = twin(*args, **kw)
    n0 = wrapper.launches
    got_p, got_u = wrapper(*args, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == n0 + 1
    assert torch.isfinite(got_p).all() and torch.isfinite(got_u).all()
    scale = twin_p.abs().max().item()
    assert (got_p - twin_p).abs().max().item() <= 5e-5 * scale
    uscale = twin_u.abs().max().item()
    assert (got_u - twin_u).abs().max().item() <= 5e-5 * uscale
    assert got_p[:, 2:].abs().max().item() == 0.0
    assert got_u[N:].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("theta", [False, True], ids=["k4", "k5"])
def test_cuda_global_wrappers_refuse_np_above_64(theta):
    """NP=72 is past what the kernels hold: the wrapper raises before any
    launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args, kw = global_tables(68, 2, 8, device="cuda", theta=theta)
    wrapper = gs.online_sweep_theta_pallas if theta else gs.online_sweep_pallas
    n0 = wrapper.launches
    with pytest.raises(ValueError, match="at most 64"):
        wrapper(*args, **kw)
    assert wrapper.launches == n0


def _held_global(got, want):
    got_p, got_u = got
    want_p, want_u = want
    assert torch.isfinite(got_p).all() and torch.isfinite(got_u).all()
    scale = want_p.abs().max().item()
    assert (got_p - want_p).abs().max().item() <= 5e-5 * scale
    uscale = want_u.abs().max().item()
    assert (got_u - want_u).abs().max().item() <= 5e-5 * uscale


#: (design → the K3 and K5 entries that launch it).
THETA_ENTRIES = {"serving": (rs.online_sweep_theta_pallas_v2,
                             gs.online_sweep_theta_pallas),
                 "first": (rs._first_design_theta_v2,
                           gs._first_design_theta)}


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["serving", "first"])
@pytest.mark.parametrize("N,nt,B,step0,options", RESID_CASES)
def test_cuda_k3_designs_match_twins(N, nt, B, step0, options, design):
    """Each K3 design against the op-for-op twin, the split twin and the
    other design, within 5e-5·scale (probes, state registers 0 and 2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args, kw = resid_tables(N, nt, B, seed=N + step0 + 7, device="cuda",
                            theta=True, step0=step0, **options)
    other = "first" if design == "serving" else "serving"
    got = THETA_ENTRIES[design][0](*args, **kw)
    torch.cuda.synchronize()
    _held_to(got, rs.theta_sweep_v2_reference(*args, **kw))
    _held_to(got, rs.theta_sweep_v2_split(*args, **kw))
    _held_to(got, THETA_ENTRIES[other][0](*args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["serving", "first"])
@pytest.mark.parametrize("N,nt,B,options", GLOBAL_CASES)
def test_cuda_k5_designs_match_twins(N, nt, B, options, design):
    """Each K5 design against the op-for-op twin, the split twin and the
    other design, within 5e-5·scale; the padded probe rows and uN entries
    are exact zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args, kw = global_tables(N, nt, B, seed=N + 3, device="cuda",
                             theta=True, **options)
    other = "first" if design == "serving" else "serving"
    got = THETA_ENTRIES[design][1](*args, **kw)
    torch.cuda.synchronize()
    _held_global(got, gs.theta_sweep_reference(*args, **kw))
    _held_global(got, gs.theta_sweep_split(*args, **kw))
    _held_global(got, THETA_ENTRIES[other][1](*args, **kw))
    assert got[0][:, 2:].abs().max().item() == 0.0
    assert got[1][N:].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("step0", [0, 30])
def test_cuda_k3_serving_chains_bit_for_bit(step0):
    """K3's serving body over two launches chained through the dd state
    equals one launch over the same steps, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args, kw = resid_tables(32, 30, 67, seed=5, device="cuda", theta=True,
                            step0=step0)
    wrapper = rs.online_sweep_theta_pallas_v2
    p1, s1 = wrapper(*args, **kw)
    h = 12

    def part(lo, hi):     # the θ streams and g lead the arguments
        return [a[lo:hi] if i < 4 else a for i, a in enumerate(args[:-1])]

    pa, sa = wrapper(*part(0, h), args[-1], **kw)
    pb, sb = wrapper(*part(h, 30), sa, **dict(kw, step0=step0 + h))
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([pa, pb]), p1)
    assert torch.equal(sb, s1)


@pytest.mark.cuda
def test_cuda_theta_launch_counters_follow_the_design():
    """The wrappers launch the serving body and only it; the first-design
    entries the first design; each launch counts once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cases = ((rs.online_sweep_theta_pallas_v2,
              resid_tables(24, 8, 64, seed=3, device="cuda", theta=True)),
             (gs.online_sweep_theta_pallas,
              global_tables(15, 8, 64, seed=3, device="cuda", theta=True)))
    for k, (wrapper, (args, kw)) in enumerate(cases):
        for design, moved in (("serving", (1, 1, 0)), ("first", (1, 0, 1))):
            before = (wrapper.launches, wrapper.serving_launches,
                      wrapper.first_design_launches)
            THETA_ENTRIES[design][k](*args, **kw)
            torch.cuda.synchronize()
            after = (wrapper.launches, wrapper.serving_launches,
                     wrapper.first_design_launches)
            assert tuple(b - a for a, b in zip(before, after)) == moved


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K3", "K5"])
def test_cuda_theta_clocks_match_plain(kernel):
    """The CLOCKED serving body of K3 (NP 32) and K5 (NP 24) computes what
    the plain one computes and reports a positive cycle count for every
    block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if kernel == "K3":
        args, kw = resid_tables(32, 30, 67, seed=6, device="cuda",
                                theta=True, step0=30)
        plain = rs.online_sweep_theta_pallas_v2(*args, **kw)
        p, s, clk = rs._theta_v2_clocked(*args, **kw)
        torch.cuda.synchronize()
        _held_to((p, s), plain)
    else:
        args, kw = global_tables(20, 24, 130, seed=6, device="cuda",
                                 theta=True)
        plain = gs.online_sweep_theta_pallas(*args, **kw)
        p, s, clk = gs._theta_clocked(*args, **kw)
        torch.cuda.synchronize()
        _held_global((p, s), plain)
    assert clk.shape[1] == len(k1.SERVING_PHASES) + 1
    assert (clk[:, -1] > 0).all()
    assert (clk[:, :-1].sum(dim=1) <= clk[:, -1]).all()


#: (design → the K2 and K4 entries that launch it).
TABLE_ENTRIES = {"serving": (rs.online_sweep_pallas_v2,
                             gs.online_sweep_pallas),
                 "first": (rs._first_design_v2, gs._first_design_tables)}


def _lane_major_call(wrapper, args, kw):
    """``wrapper`` on the lane-major tables of ``args``, as the engines
    hand them down."""
    return wrapper(*rs.lane_major(*args[:3]), *args[3:], lane_major=True,
                   **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["serving", "first"])
@pytest.mark.parametrize("N,nt,B,step0,options", RESID_CASES)
def test_cuda_k2_designs_match_twins(N, nt, B, step0, options, design):
    """Each K2 design against the op-for-op twin, the split twin and the
    other design, within 5e-5·scale (probes, state registers 0 and 2);
    the serving body gives the same result, bit for bit, from lane-major
    tables."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args, kw = resid_tables(N, nt, B, seed=N + step0 + 11, device="cuda",
                            step0=step0, **options)
    other = "first" if design == "serving" else "serving"
    got = TABLE_ENTRIES[design][0](*args, **kw)
    torch.cuda.synchronize()
    _held_to(got, rs.sweep_v2_reference(*args, **kw))
    _held_to(got, rs.sweep_v2_split(*args, **kw))
    _held_to(got, TABLE_ENTRIES[other][0](*args, **kw))
    if design == "serving":
        lm = _lane_major_call(rs.online_sweep_pallas_v2, args, kw)
        assert all(torch.equal(x, y) for x, y in zip(got, lm))


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["serving", "first"])
@pytest.mark.parametrize("N,nt,B,options", GLOBAL_CASES)
def test_cuda_k4_designs_match_twins(N, nt, B, options, design):
    """Each K4 design against the op-for-op twin, the split twin and the
    other design, within 5e-5·scale; the padded probe rows and uN entries
    are exact zeros; the serving body gives the same result, bit for bit,
    from lane-major tables."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args, kw = global_tables(N, nt, B, seed=N + 5, device="cuda", **options)
    other = "first" if design == "serving" else "serving"
    got = TABLE_ENTRIES[design][1](*args, **kw)
    torch.cuda.synchronize()
    _held_global(got, gs.sweep_reference(*args, **kw))
    _held_global(got, gs.sweep_split(*args, **kw))
    _held_global(got, TABLE_ENTRIES[other][1](*args, **kw))
    assert got[0][:, 2:].abs().max().item() == 0.0
    assert got[1][N:].abs().max().item() == 0.0
    if design == "serving":
        lm = _lane_major_call(gs.online_sweep_pallas, args, kw)
        assert all(torch.equal(x, y) for x, y in zip(got, lm))


@pytest.mark.cuda
@pytest.mark.parametrize("step0", [0, 30])
def test_cuda_k2_serving_chains_bit_for_bit(step0):
    """K2's serving body over two launches chained through the dd state
    equals one launch over the same steps, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args, kw = resid_tables(32, 30, 67, seed=8, device="cuda", step0=step0)
    lm = rs.lane_major(*args[:3])
    kw = dict(kw, lane_major=True)
    wrapper = rs.online_sweep_pallas_v2
    p1, s1 = wrapper(*lm, *args[3:], **kw)
    h = 12

    def part(lo, hi):     # the tables and g lead the arguments
        return [t[lo:hi] for t in lm] + [args[3][lo:hi]] + list(args[4:-1])

    pa, sa = wrapper(*part(0, h), args[-1], **kw)
    pb, sb = wrapper(*part(h, 30), sa, **dict(kw, step0=step0 + h))
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([pa, pb]), p1)
    assert torch.equal(sb, s1)


@pytest.mark.cuda
def test_cuda_table_launch_counters_follow_the_design():
    """K2's and K4's wrappers launch the serving body and only it; the
    first-design entries the first design; each launch counts once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cases = ((rs.online_sweep_pallas_v2,
              resid_tables(24, 8, 64, seed=3, device="cuda")),
             (gs.online_sweep_pallas,
              global_tables(15, 8, 64, seed=3, device="cuda")))
    for k, (wrapper, (args, kw)) in enumerate(cases):
        for design, moved in (("serving", (1, 1, 0)), ("first", (1, 0, 1))):
            before = (wrapper.launches, wrapper.serving_launches,
                      wrapper.first_design_launches)
            TABLE_ENTRIES[design][k](*args, **kw)
            torch.cuda.synchronize()
            after = (wrapper.launches, wrapper.serving_launches,
                     wrapper.first_design_launches)
            assert tuple(b - a for a, b in zip(before, after)) == moved


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,N", [("K2", 32), ("K2", 48), ("K4", 15)])
def test_cuda_table_clocks_match_plain(kernel, N):
    """The CLOCKED serving body of K2 (NP 32 and 48) and K4 (NP 16)
    computes what the plain one computes, bit for bit, and reports a
    positive cycle count for every block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if kernel == "K2":
        args, kw = resid_tables(N, 10, 67, seed=6, device="cuda", step0=10)
        plain = rs.online_sweep_pallas_v2(*args, **kw)
        p, s, clk = rs._v2_clocked(*args, **kw)
    else:
        args, kw = global_tables(N, 24, 130, seed=6, device="cuda")
        plain = gs.online_sweep_pallas(*args, **kw)
        p, s, clk = gs._tables_clocked(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(p, plain[0]) and torch.equal(s, plain[1])
    assert clk.shape[1] == len(k1.SERVING_PHASES) + 1
    assert (clk[:, -1] > 0).all()
    assert (clk[:, :-1].sum(dim=1) <= clk[:, -1]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("N,B", [(32, 512), (48, 128)])
def test_cuda_table_lanes(N, B):
    """K2's lanes a block at the batches it serves (B=512 at 50x32, B=128
    at 150x48): the host rule on this card's SM count (4 lanes on a card
    of 128 SMs or more), a tile the kernel takes; every tile it takes
    gives the same result, bit for bit; a larger one is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    NP = k1.pad_dim(N)
    lanes = rs.table_lanes(B, NP, "cuda")
    assert lanes == rs.pick_table_lanes(B, NP, n_sm)
    if n_sm >= 128:
        assert lanes == 4
    tile = rs.resid_tables_tile(NP, lanes)
    assert tile["lanes"] == lanes and tile["threads"] == lanes * NP
    assert tile["lanes_max"] == rs.table_lanes_max(NP)
    assert tile["ring_units"] >= 2 and tile["ks"] >= 1
    args, kw = resid_tables(N, 6, B, seed=4, device="cuda", step0=6)
    want = rs.online_sweep_pallas_v2(*args, **kw)
    for tl in rs.TABLE_LANES:
        if tl > rs.table_lanes_max(NP):
            with pytest.raises(RuntimeError, match="launch failed"):
                rs._v2_lanes(*args, lanes=tl, **kw)
            continue
        got = rs._v2_lanes(*args, lanes=tl, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
def test_cuda_fleet_routed_and_lanes():
    """A two-cell fleet on the card, one cell of each serving shape
    (50x32, and 150x48 registered) on the flagship time grid (nt=1500: at
    nt=120 the paired-LU followers' stale factors alone miss the limit by
    ~30×, on the CPU twin too, while the per-step LU meets it), 32 μ in
    each, the fused K1 (budget 0): the routed rows equal each cell's
    direct solve_batch on the same padded sub-batch bit for bit, one K1
    launch per cell, and each cell's served K1 meets the float32 lanes
    engine at tests/test_windowed.py:91-94's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rom = synthetic_fleet(cell_wn=((50, 32), (150, 48)), register=(1,),
                          nx=200, nt=1500, device="cuda")
    rom.ONLINE_PRECOMPUTE_BUDGET = 0
    ml = rom.mulocal
    draw = synthetic_mus(256, seed=9)
    cells = ml.cell_of([rom.compute_piston_mach_number(m) for m in draw])
    mus = [m for c in (0, 1) for m in
           [draw[int(i)] for i in np.nonzero(cells == c)[0][:32]]]
    n0 = k1.online_sweep_windowed_fused.serving_launches
    routed = rom.solve_batch_mulocal(mus)
    assert k1.online_sweep_windowed_fused.serving_launches == n0 + 2
    for c in (0, 1):
        sub = mus[32 * c:32 * (c + 1)] * 2
        rom._set_serving_windows(ml.cells[c])
        direct = rom.solve_batch(sub, mode="probes")
        for j in range(32):
            i = 32 * c + j
            assert np.array_equal(routed["probes"][i], direct["probes"][j])
            assert np.array_equal(routed["uN_final"][i],
                                  direct["uN_final"][j])
        lanes = rom.solve_batch(sub, mode="probes", engine="windowed")
        scale = max(np.abs(lanes["probes"]).max(), 1e-3)
        assert np.abs(direct["probes"] - lanes["probes"]).max() <= (
            5e-6 * scale)
        assert np.abs(direct["uN_final"] - lanes["uN_final"]).max() <= 5e-5
    assert routed["dil"][:32].tolist() == [1.0] * 32
    assert (routed["dil"][32:] != 1.0).any()


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("budget,kernel", [(None, "K4"), (0, "K5")])
def test_cuda_global_lanes_against_served(budget, kernel):
    """The float32 global lanes engine (mode="reduced", no engine) against
    the served K4 or K5 on the same μ at tests/test_rom.py:196-200's
    limits (probes 3e-5·scale, uN_final 1e-4·max(|uN|, 1))."""
    _need_cuda()
    from romtime_tpu_torch.rom.engines import global_fused as engine

    rom = synthetic_estimator(nx=200, nt=300, device="cuda").rom
    if budget is not None:
        rom.ONLINE_PRECOMPUTE_BUDGET = budget
    mus = synthetic_mus(128, seed=3)
    assert rom._resolve_engine("reduced", 128) == "lanes"
    counter = (engine.online_sweep_pallas if kernel == "K4"
               else engine.online_sweep_theta_pallas)
    lanes = rom.solve_batch(mus)
    n0 = counter.serving_launches
    served = rom.solve_batch(mus, mode="probes")
    assert counter.serving_launches == n0 + 1
    scale = np.abs(lanes["probes"]).max()
    assert np.abs(served["probes"] - lanes["probes"]).max() <= 3e-5 * scale
    uN = lanes["uN"][:, -1]
    assert np.abs(served["uN_final"] - uN).max() <= (
        1e-4 * max(np.abs(uN).max(), 1.0))


@pytest.mark.cuda
def test_cuda_global_estimator_card_vs_cpu():
    """estimate_batch in float64 on the card against the explicit CPU run:
    the sweeps within 1e-9·scale, the estimator the reconstruction-norm
    formula on its trajectories (rtol 1e-10) and within the triangle
    bound of the sweeps' gaps (tests/test_hrom.py:442-520)."""
    _need_cuda()
    from romtime_tpu_torch.dtypes import compute_dtype_scope
    from romtime_tpu_torch.utils import compute_rom_difference

    mus = certification_mus()
    outs = {}
    for dev in ("cuda", "cpu"):
        est = synthetic_estimator(nx=200, nt=150, device=dev)
        with compute_dtype_scope(torch.float64):
            outs[dev] = est.estimate_batch(mus)
    got, ref = outs["cuda"], outs["cpu"]
    traj = {}
    for name in ("rom", "srom"):
        for key in ("uN", "probes"):
            a, b = got[name][key].cpu(), ref[name][key]
            assert (a - b).abs().max().item() <= 1e-9 * b.abs().max().item()
        traj[name] = (got[name]["uN"].movedim(-1, 0).cpu().numpy(),
                      ref[name]["uN"].movedim(-1, 0).numpy())
    V = np.asarray(est.srom.global_serving.basis)
    e, e_cpu = got["estimator"], ref["estimator"]
    assert e.shape == (16, 150) and np.isfinite(e).all() and (e >= 0).all()
    for b in range(16):
        same = [compute_rom_difference(traj["rom"][0][b, i],
                                       traj["srom"][0][b, i], V)
                for i in range(150)]
        np.testing.assert_allclose(e[b], same, rtol=1e-10, atol=1e-17)
        noise = sum(np.linalg.norm(g[b] - c[b], axis=1)
                    for g, c in traj.values()) / np.sqrt(V.shape[0])
        assert np.all(np.abs(e[b] - e_cpu[b])
                      <= noise + 1e-12 * e_cpu[b] + 1e-16)


@pytest.mark.cuda
def test_cuda_fleet_estimator():
    """estimate_batch_mulocal in float64 on a nested two-cell fleet: the
    rows of a permuted batch bit for bit, the served fleet untouched, each
    μ's merged trajectories within 1e-9·scale of the CPU run's and the
    estimators within the triangle bound of those gaps
    (tests/test_hrom.py:442-520)."""
    _need_cuda()
    from romtime_tpu_torch.dtypes import compute_dtype_scope
    from romtime_tpu_torch.rom.hrom import HyperReducedPiston

    mus = synthetic_mus(16, seed=4)
    outs = {}
    for dev in ("cuda", "cpu"):
        rom = synthetic_fleet(cell_wn=((4, 8), (6, 12)), register=(1,),
                              nx=200, nt=120, srom_extra=8, device=dev)
        hp = HyperReducedPiston.from_serving(rom)
        before = rom.solve_batch_mulocal(mus)
        with compute_dtype_scope(torch.float64):
            outs[dev] = hp.estimate_batch_mulocal(mus)
            if dev == "cuda":
                perm = np.random.default_rng(1).permutation(16)
                again = hp.estimate_batch_mulocal([mus[i] for i in perm])
                np.testing.assert_array_equal(
                    again["estimator"], outs[dev]["estimator"][perm])
        after = rom.solve_batch_mulocal(mus)
        for k, v in before.items():
            for a, b in zip(after[k], v):
                np.testing.assert_array_equal(a, b)
    e, e_cpu = outs["cuda"]["estimator"], outs["cpu"]["estimator"]
    assert e.shape == (16, 120)
    assert (outs["cuda"]["estimator_average"] > 0).all()
    Nh = np.asarray(rom.mulocal.cells_srom[0].Vs).shape[1]
    for b in range(16):
        noise = 0.0
        for key in ("rom", "srom"):
            g, c = outs["cuda"][key][b], outs["cpu"][key][b]
            assert np.abs(g - c).max() <= 1e-9 * max(np.abs(c).max(), 1e-30)
            noise = noise + np.linalg.norm(g - c, axis=1)
        assert np.all(np.abs(e[b] - e_cpu[b])
                      <= noise / np.sqrt(Nh) + 1e-12 * e_cpu[b] + 1e-16)


@pytest.mark.cuda
def test_cuda_chained_card_vs_cpu():
    """The chained lanes variant in float64 on unequal widths (W=7 on
    nt=150), card against the explicit CPU run at 1e-9·scale, and on
    equal widths against the equal-width engine."""
    _need_cuda()
    from romtime_tpu_torch.dtypes import compute_dtype_scope
    from romtime_tpu_torch.rom.engines import windowed_lanes

    mus = synthetic_mus(16, seed=6)
    outs = {}
    with compute_dtype_scope(torch.float64):
        for dev in ("cuda", "cpu"):
            cell = synthetic_cell(seed=7, nx=200, nt=150, n_windows=7, N=12,
                                  device=dev)
            assert len(set(np.diff(cell.windows.bounds).tolist())) > 1
            outs[dev] = cell.solve_batch(mus, engine="windowed")
        equal = synthetic_cell(seed=7, nx=200, nt=150, n_windows=5, N=12,
                               device="cuda")
        want = equal.solve_batch(mus, engine="windowed", host=False)
        direct = windowed_lanes.online_sweep_windowed_chained(
            equal.fom, equal.windows, equal._theta_sources(),
            equal._lanes_tables("reduced"), equal._mu_batch(mus), "reduced")
    for key in ("uN", "probes"):
        scale = np.abs(outs["cpu"][key]).max()
        assert np.abs(outs["cuda"][key] - outs["cpu"][key]).max() <= (
            1e-9 * scale)
        scale = want[key].abs().max().item()
        assert (direct[key] - want[key]).abs().max().item() <= 1e-9 * scale


#: The FOM card tests' grid (the CPU parity tests' conftest size).
FOM_GRID = (1.0, 150, 0.6, 96)


def _fom_pair(bdf="2"):
    from romtime_tpu_torch.convert import piston_fom

    return {dev: piston_fom(*FOM_GRID, bdf=bdf, device=dev)
            for dev in ("cuda", "cpu")}


@pytest.mark.cuda
@pytest.mark.parametrize("bdf", ["2", "1"])
@pytest.mark.parametrize("dd", [False, True])
def test_cuda_fom_sweep_card_vs_cpu(dd, bdf):
    """solve_fom_batch in float64 on the card against the same sweep on
    the CPU: every output within 1e-10 relative per μ (the same code,
    other reduction orders); the reference's keys and shapes."""
    _need_cuda()
    from romtime_tpu_torch.dtypes import compute_dtype_scope
    from romtime_tpu_torch.parallel import solve_fom_batch

    mus = synthetic_mus(3, seed=9)
    outs = {}
    with compute_dtype_scope(torch.float64):
        for dev, fom in _fom_pair(bdf).items():
            fom.dd_sweep = dd
            outs[dev] = solve_fom_batch(fom, mus)
    got, want = outs["cuda"], outs["cpu"]
    keys = {"uh", "uc", "x", "t", "probes", "nonlinear_data"}
    assert set(got) == set(want) == keys | ({"uh_lo"} if dd else set())
    assert got["uh"].shape == (3, 96, 151)
    for key in keys - {"t"}:
        a = got[key].reshape(3, -1)
        b = want[key].reshape(3, -1)
        assert np.isfinite(a).all(), key
        rel = np.linalg.norm(a - b, axis=1) / np.linalg.norm(b, axis=1)
        assert rel.max() <= 1e-10, (key, rel)
    assert np.array_equal(got["t"], want["t"])


@pytest.mark.cuda
def test_cuda_fom_solve_and_f32_sweep():
    """fom.solve() on the card equals its row of the float64 batch
    (1e-12); the float32 plain and dd sweeps on the card stay within the
    reference's float32 limits of that trajectory (tests/test_fom_dd.py:
    60-68: dd drift < 1e-4 and < 5× the plain drift; the low words
    0 < |lo| < 1e-5·|hi|)."""
    _need_cuda()
    from romtime_tpu_torch.dtypes import compute_dtype_scope
    from romtime_tpu_torch.parallel import solve_fom_batch

    mus = synthetic_mus(3, seed=9)
    fom = _fom_pair()["cuda"]
    with compute_dtype_scope(torch.float64):
        ref = solve_fom_batch(fom, mus)
        fom.update_parametrization(mus[1])
        fom.solve()
    row = ref["uh"][1].T
    assert (np.linalg.norm(fom.solutions.snapshots - row)
            <= 1e-12 * np.linalg.norm(row))
    drift = {}
    for dd in (False, True):
        fom.dd_sweep = dd
        out = solve_fom_batch(fom, mus)
        traj = out["uh"].astype(np.float64) + out.get("uh_lo", 0.0)
        drift[dd] = max(np.linalg.norm(traj[b] - ref["uh"][b])
                        / np.linalg.norm(ref["uh"][b]) for b in range(3))
    assert drift[True] < 1e-4 and drift[True] < 5.0 * drift[False], drift
    hi, lo = np.abs(out["uh"]).max(), np.abs(out["uh_lo"]).max()
    assert 0 < lo < 1e-5 * hi


@pytest.mark.cuda
def test_cuda_offline_build_card_vs_cpu(tmp_path, monkeypatch):
    """The port builds bench.py's throughput profile at nx=200, nt=300
    (``problems.throughput_profile``: 3 offline μ, S-ROM N=20, ROM N=15)
    on the card and on the CPU, float64, each in its own directory: the
    same offline μ, the same dofs for every reductor (as sets: a
    degenerate collateral spectrum leaves the greedy's order to the SVD's
    rotation), the two builds' float64 lanes probes within 1e-9·scale,
    and the card build's served K4 (ROM) and K5 (S-ROM) launched."""
    _need_cuda()
    from romtime_tpu_torch.dtypes import compute_dtype_scope
    from romtime_tpu_torch.problems import throughput_profile
    from romtime_tpu_torch.rom.hrom import HyperReducedPiston

    builds = {}
    for dev in ("cuda", "cpu"):
        workdir = tmp_path / dev
        workdir.mkdir()
        monkeypatch.chdir(workdir)
        hrom = HyperReducedPiston(**throughput_profile(nx=200, nt=300,
                                                       device=dev))
        hrom.setup()
        hrom.setup_hyperreduction()
        hrom.run_offline_rom(device_sweep=True)
        hrom.run_offline_hyperreduction(mu_space=hrom.mu_space["offline"],
                                        evaluate=False)
        hrom.project_reductors()
        builds[dev] = hrom
    card, cpu = builds["cuda"], builds["cpu"]
    assert card.mu_space["offline"] == cpu.mu_space["offline"]
    assert (card.rom.N, card.srom.N) == (15, 20) == (cpu.rom.N, cpu.srom.N)
    for attr in ("mdeim_Mh", "mdeim_Ah", "deim_rhs", "mdeim_Ch",
                 "mdeim_Nh_hat", "mdeim_Nh"):
        assert sorted(getattr(card.rom, attr).dofs) == sorted(
            getattr(cpu.rom, attr).dofs), attr
    mus = synthetic_mus(8, seed=3)
    with compute_dtype_scope(torch.float64):
        got = card.rom.solve_batch(mus, mode="probes", engine="lanes")
        want = cpu.rom.solve_batch(mus, mode="probes", engine="lanes")
    scale = np.abs(want["probes"]).max()
    assert np.abs(got["probes"] - want["probes"]).max() <= 1e-9 * scale
    k4, k5 = gs.online_sweep_pallas.launches, \
        gs.online_sweep_theta_pallas.launches
    batch = synthetic_mus(128, seed=4)
    card.srom.ONLINE_PRECOMPUTE_BUDGET = 0   # θ per step: K5
    for rom in (card.rom, card.srom):
        out = rom.solve_batch(batch, mode="probes", engine="pallas")
        assert np.isfinite(out["probes"]).all()
    assert gs.online_sweep_pallas.launches > k4
    assert gs.online_sweep_theta_pallas.launches > k5


@pytest.mark.cuda
def test_cuda_fleet_build_card_vs_cpu(tmp_path, monkeypatch):
    """The port builds the conftest-size piston pipeline (nx=150, nt=96,
    ``problems.piston_profile``) and its registered two-cell fleet (W=4,
    N=12, 3 μ a cell, RandomState(2), cell 1 registered; the serial
    float64 path) on the card and on the CPU, each in its own directory:
    the same training μ and laws, the two fleets' float64 windowed lanes
    probes within 1e-9·scale, and the card's fleet served through K1's
    serving design, one launch per occupied cell."""
    _need_cuda()
    from romtime_tpu_torch.dtypes import compute_dtype_scope
    from romtime_tpu_torch.problems import piston_profile
    from romtime_tpu_torch.rom.hrom import HyperReducedPiston

    builds = {}
    for dev in ("cuda", "cpu"):
        workdir = tmp_path / dev
        workdir.mkdir()
        monkeypatch.chdir(workdir)
        hrom = HyperReducedPiston(**piston_profile(
            nx=150, nt=96, tf=0.6, n_offline=3, modes=None, truncate=2,
            nmdeim=10, tri_mu=2, walk_stride=1, device=dev))
        hrom.setup()
        hrom.setup_hyperreduction()
        hrom.run_offline_rom()
        hrom.run_offline_hyperreduction(mu_space=hrom.mu_space["offline"],
                                        evaluate=False)
        hrom.project_reductors()
        hrom.build_mulocal_serving(n_cells=2, n_windows=4, num_basis=12,
                                   snapshots_per_cell=3,
                                   rnd=np.random.RandomState(2),
                                   register=[1], dump=False)
        builds[dev] = hrom
    card, cpu = builds["cuda"], builds["cpu"]
    assert card.cell_mus == cpu.cell_mus
    ml, ml_cpu = card.rom.mulocal, cpu.rom.mulocal
    np.testing.assert_array_equal(ml.edges, ml_cpu.edges)
    assert ml.cells[0].dilation is None and ml_cpu.cells[0].dilation is None
    law, law_cpu = ml.cells[1].dilation, ml_cpu.cells[1].dilation
    assert law.names == law_cpu.names
    np.testing.assert_allclose(law.coef, law_cpu.coef, rtol=1e-9, atol=0)
    np.testing.assert_allclose(card.cell_dilations[1],
                               cpu.cell_dilations[1], rtol=0, atol=1e-10)
    mus = [dict(a0=9.8, omega=15.5, delta=0.10, alpha=1e-6, gamma=1.4),
           dict(a0=8.1, omega=19.5, delta=0.148, alpha=1e-6, gamma=1.4),
           dict(a0=9.3, omega=17.5, delta=0.12, alpha=1e-6, gamma=1.4)]
    with compute_dtype_scope(torch.float64):
        got = card.rom.solve_batch_mulocal(mus, mode="probes",
                                           engine="windowed")
        want = cpu.rom.solve_batch_mulocal(mus, mode="probes",
                                           engine="windowed")
    scale = np.abs(want["probes"]).max()
    assert np.abs(got["probes"] - want["probes"]).max() <= 1e-9 * scale
    np.testing.assert_array_equal(got["dil"], want["dil"])

    rom = card.rom
    rom.ONLINE_PRECOMPUTE_BUDGET = 0     # the fused branch at a small B
    batch = synthetic_mus(64, seed=6)
    occupied = len(set(ml.cell_of([rom.compute_piston_mach_number(m)
                                   for m in batch]).tolist()))
    n0 = k1.online_sweep_windowed_fused.serving_launches
    out = rom.solve_batch_mulocal(batch, mode="probes")
    torch.cuda.synchronize()
    assert k1.online_sweep_windowed_fused.serving_launches == n0 + occupied
    assert np.isfinite(out["probes"]).all()
