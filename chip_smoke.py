"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. the card's name and power limit (nvidia-smi);
2. build of every kernel of the serving paths with nvcc for sm_90a, one
   nvcc per source, all at once, with each source's nvcc seconds: the
   serving body (romtime_tpu_torch/csrc/serving_body.cuh) in K1's serving
   design and K3 (romtime_tpu_torch/csrc/windowed_serving.cu), in K5
   (romtime_tpu_torch/csrc/global_serving.cu), and over materialized
   tables in K2 (romtime_tpu_torch/csrc/resid_tables_serving.cu) and K4
   (romtime_tpu_torch/csrc/global_tables_serving.cu); K1's first design
   (romtime_tpu_torch/csrc/windowed_fused.cu); K2 and K3's first designs
   (romtime_tpu_torch/csrc/resid_sweep.cu); K4 and K5's first designs
   (romtime_tpu_torch/csrc/global_sweep.cu); each instantiation's
   registers and spills (``-Xptxas -v``): no instantiation of the serving
   body may spill;
3. kernel phase, each kernel against its plain PyTorch twin, both on the
   card: K1-K3 at the fleet's two windowed serving shapes (50 windows ×
   30 steps at N=32, 150 × 10 at N=48): K1 (B=2048) with paired LU G=5
   "sub1", the per-step LU and the Richardson solve (solve_iters=5) on
   the same damped tables, each timed on both designs in turns (first,
   serving, serving, first), the serving design held against the first
   over the whole sweep, against the twin on the first 4 windows and,
   for sub1 and Richardson, over the whole sweep; then the serving
   design's phase clocks (its CLOCKED instantiation beside the plain
   one; shares reported where the totals agree within 3%); K2 (B=512 at
   50x32, B=128 at 150x48) and K3 (B=2048) over one window launch with
   step0 > 0 from a nonzero carried state, each on both designs in turns
   (serving, first, first, serving), held against its first design, the
   twin and the split twin, with the serving body's phase clocks (K2's
   serving body on lane-major tables, the conversion from the reference
   layout timed apart; at 50x32 also at 4, 8 and 16 lanes a block); K4
   and K5 over a whole global sweep (nt=1500): K4 at N=15, K5 at N=15 and
   N=20 (B=2048, the throughput ROM and S-ROM), each also at N=9 with
   BDF-1 and no trilinear term, and at B=1000 (not a multiple of 128),
   each on both designs in turns as K2 and K3, with the phase clocks at
   N=15 (K4) and N=20 (K5). Errors against 5e-5·scale; ms per call of the
   kernel and of the twin, and the bound;
4. K1 options phase (the first design), at both windowed shapes
   (B=2048) on the same tables: the first design's cost ledger
   (romtime_tpu_torch/kernel_ledger.py: every ablated variant with the
   LU schedule and with Richardson, and the derived components), then
   each paired-LU follower mode (warm1, warm2, warmx, inv1, inv2; G=5)
   over a whole sweep with its ms, bound and probe gap to the per-step
   LU and to sub1, and each mode and each ablation (with both solves)
   against its twin on the first 4 windows (5e-5·scale);
5. windowed serving phase on the seeded synthetic 50x32 cell (real piston
   FOM, nx=1000, nt=1500) through ``solve_batch(mus, mode="probes",
   probe_reduce="mean")``, one stage-2 branch after the other, each with
   every launch counter set to 0 just before it and read just after:
   B=2048 (fused K1 with the LU schedule, one launch of the serving
   design per call and none of the first), B=512
   (materialized tables, K2 once per window: 50 per call), B=2048 under
   ROMTIME_WINDOWED_KERNEL=v2 (K3's serving body once per window, its
   first design never; K2 likewise at B=512) and B=2048 on the
   fused branch with ``WINDOWED_SOLVE_ITERS = 5`` on the instance (K1
   with the Richardson solve, one launch per call). Each branch's outputs
   must be finite and agree with the same batch through the twins on the
   card, K2's and K3's with K1's on the same μ, and the Richardson
   branch's with the LU schedule's within the reference's 1e-3·scale
   (tests/test_pallas_online.py:664-665). The solve policy's own decision
   and measured ρ for the cell are printed; the pivot-free guard prints
   "skipped (no global basis)" there and cond₂ on the global cells;
6. global serving phase (``engine="pallas"``) on the seeded synthetic
   global cells (same FOM), the same way: N=15 at B=2048 (materialized
   tables, one launch of K4's serving body per call), the same cell with
   the precompute budget at 0 (one launch of K5's serving body per call;
   its outputs within 3e-6·scale of K4's on the same μ) and N=20 at
   B=2048 (K5 by the budget alone); K4 and K5 on both designs in turns on
   each cell's inputs, the materialized tables' product (lane-major, as
   the engine forms them) timed against the reference layout's einsum;
7. one measured precompute autotune on the N=15 global cell at B=2048
   (record written under build/; its winner printed);
8. fleet phase, the flagship μ-local fleet (``testing.synthetic
   .synthetic_fleet``: four 50x32 cells and two 150x48 cells on the same
   FOM, equal-width Mach edges over the μ box, a guarded dilation law on
   cell 5) through ``solve_batch_mulocal(mus, mode="probes")`` at
   B=2048: the cell occupancy, each cell's stage-2 branch and the solve
   the fleet policy picks for its (W, N) group, then one cold call (each
   cell's device tables built on it) and 3 warm calls, every launch
   counter set to 0 before the cold call and read after the last (one
   launch of K1's serving design per occupied cell and call, no other
   launch), with each occupied cell's prep and sweep ms. Held, each a
   failure: (a) the routed rows equal each cell's direct
   ``solve_batch`` on the same padded sub-batch bit for bit; (b) at
   B=128 on cell 0 (50x32) and cell 5 (150x48), the served K1 (budget
   0) within 5e-6·scale of the port's float32 lanes engine
   (``engine="windowed"``) on the probes and 5e-5 on ``uN_final``
   (tests/test_windowed.py:91-94); (c) ``host=False`` returns CUDA
   tensors equal to the host copy;
9. certification phase, the S-ROM certification path at full width
   (nx=1000, nt=1500), every launch counter set to 0 before it and read
   after (K4 and K5 once each, by (a)'s yardsticks; the served fleet's
   kernels by (d)): (a) the global lanes engine in float32 at B=2048
   through ``solve_batch(mus, mode="reduced")`` with no engine on the
   synthetic estimator pair (``testing.synthetic.synthetic_estimator``:
   ROM N=15, its tables materialized, 5.15 GiB; S-ROM N=20, θ
   recombined per step, 9.15 GiB over the 6 GiB budget), resolved to
   "lanes", its probes within 3e-5·scale of the served K4 (N=15) and K5
   (N=20) on the same μ and ``uN_final`` within 1e-4·max(|uN|, 1)
   (tests/test_rom.py:196-200), with its solves/s; (b) ``estimate_batch``
   in float64 at B=16 (15 seeded μ and the box center), on the card and
   in an explicit CPU run (``device="cpu"``): the two runs' global lanes
   sweeps within 1e-9·scale; (c) its estimator finite, ≥ 0, (16, 1500),
   equal to ``compute_rom_difference`` on its trajectories (rtol 1e-10,
   atol 1e-17) and, card against CPU, within the triangle bound of (b)'s
   gaps (tests/test_hrom.py:442-520); (d) ``estimate_batch_mulocal`` in
   float64 at B=16 on the synthetic fleet drawn at N+8
   (``srom_extra=8``, every cell occupied): shapes, finite positive
   averages, each estimator row the coefficient-difference norm of its
   μ's merged trajectories (rtol 1e-12), a permuted batch's rows bit for
   bit, and the served fleet
   (``solve_batch_mulocal``) equal before and after bit for bit, with
   the per-cell seconds; (e) the chained lanes variant on a 50x32-recipe
   cell with W=7 unequal windows (214 and 215 steps), float64, B=16,
   ``mode="reduced"``: card against an explicit CPU run within
   1e-9·scale, and called directly on the equal-width 50x32 cell within
   1e-9·scale of the equal-width engine;
10. FOM phase, the full-order piston model at the flagship width
   (nx=1000, nt=1500, P1, BDF-2, regime "rest"; ``convert.piston_fom``)
   over 88 μ drawn from the μ box by the port's ``ParameterSampler``
   (seed 13; the flagship fleet's offline batch, bench.py:113). It runs
   no kernel of K1-K5 (plain torch, as the reference computes the FOM
   outside Pallas). (a) ``solve_fom_batch`` in float32 at B=88, plain
   and with ``dd_sweep``: the reference's keys and shapes, finite, with
   seconds a sweep, ms a step, μ·steps/s and peak device memory; (b) the
   same sweep in float64 on the card for the first 4 μ against an
   explicit CPU run (``device="cpu"``): ``uh``, ``uc``, ``probes`` and
   ``nonlinear_data`` within 1e-10 relative per μ; (c) (a)'s sweeps on
   those 4 μ against (b)'s card sweep (tests/test_fom_dd.py:60-68, :90):
   the dd drift under 1e-4 and under 5× the plain drift, the low words
   0 < |lo| < 1e-5·|hi|; (d) in float64 the piston probe equals the
   Dirichlet value bL within 1e-12 (tests/test_fom_piston.py:54-59); (e)
   ``fom.solve()`` on the card in float64 for the first μ equals its row
   of (b) within 1e-12 relative.
11. offline build phase: the port builds its own global ROM on the card,
   ``bench.py``'s throughput profile (``problems.throughput_profile``:
   nx=1000, nt=1500, P1, BDF-2, 3 offline μ from the Mach-stratified
   sampler with RandomState(0), S-ROM N=20, ROM N=15, N-MDEIM 12 modes,
   the tree walk on 100 times, all six operator models) through
   ``HyperReducedPiston``'s ``setup``, ``setup_hyperreduction``,
   ``run_offline_rom(device_sweep=True)``,
   ``run_offline_hyperreduction``, ``project_reductors`` and the dumps,
   in float64, in a temporary directory: (a) the seconds of each stage
   (set-up, FOM sweep, POD, each reductor's training, projection, the
   trilinear tables with the global configurations, the dumps), the
   snapshot-assembly calls, peak device memory, N and each reductor's
   dof count; (b) ``solve_batch(mus, mode="probes")`` at B=2048 on the
   built ROM (N=15, K4) and S-ROM (N=20, K5), a cold and a warm call
   each, every launch counter set to 0 before and read after (K4 and K5
   each launched, K1-K3 never), with the engine, branch and solves/s;
   the ROM again with the budget at 0 (K5) within 3e-6·scale of K4
   (tests/test_rom.py:226-227); the served probes of the first 16 μ
   within 3e-5·scale, ``uN_final`` within 1e-4·max(|uN|, 1), of the
   float64 global lanes engine on the same built ROMs
   (tests/test_rom.py:196-200); (c) ``estimate_batch`` in float64 at B=16
   on the built pair, the card against the same pair carried to the CPU
   (``convert.estimator_to_arrays``), by phase 9's contract; (d) the
   same build on the CPU (``device="cpu"``, full width): the same offline
   μ, the same dofs (as sets; their order printed), and the two builds'
   float64 lanes probes within 1e-9·scale.
12. fleet build phase: the port builds the flagship μ-local fleet on the
   card from a global ROM it built itself, in float64 in a temporary
   directory (``problems.joint_profile``/``joint_fleet``,
   bench.py:64-115, at full width, its depth cut: 2,2,2,2,5 training μ
   in cells 0-4 and bench's 24 in the top cell, which is registered):
   (a) the global build (nx=1000, nt=1500, 8 offline μ, S-ROM N=96, ROM
   N=88, N-MDEIM 96 modes) by phase 11's stages, with each stage's
   seconds; (b) ``build_mulocal_serving(device_sweep=True,
   srom_extra=8)``: six Mach cells (50x32 ×4, 150x48 ×2), the seconds of
   each stage (``hrom.fleet_seconds``), each cell's training μ, law and
   training dilations and its predicted floor, peak device memory; (c)
   ``solve_batch_mulocal(mus, mode="probes")`` at B=2048, a cold and 3
   warm calls, every counter set to 0 before the cold call and read
   after the last (one launch of K1's serving design per occupied cell
   and call, no other launch), routed ≡ direct bit for bit, registered
   lanes on d > 1 and the others on 1, and on cells 0 and 5 at B=128 the
   served K1 (the port's default schedule, the per-step LU) within
   5e-6·scale (``uN_final`` 5e-5) of the float32 lanes engine, and on
   cell 5 the reference's default schedule (``ROMTIME_PAIRED_LU=5``:
   paired LU G=5, ``sub1`` followers) served beside it, its gap
   measured; on cell 5 also the paired-LU probe's lanes
   (scripts/paired_lu_probe.py: the batch's μ of the cell, its 24
   training μ and 40 more of its μ, cycled to 128): the served K1's
   gaps to the float32 and float64 lanes engines printed, not held (the
   reference's kernel misses the float32 limit there by the same amount,
   PERF.md §6), and that launch held against K1's twin on the
   same inputs (ATOL_REL); (d) the
   float64 windowed lanes engine in ``mode="full"`` on bench's center μ
   and 4 of its held-out μ against the float64 FOM on the card on each
   lane's matched grid (T·d on a registered lane): the center under 1e-3
   (tests/test_windowed.py:398), a registered lane under 4e-3
   (tests/test_registration.py:490); (e) ``estimate_batch_mulocal`` in
   float64 at B=16 by phase 9 (d)'s contract, each row also the
   reconstruction-norm formula on its window's basis; (f) a fresh
   driver's ``start_from_existing_basis`` serving (c)'s last batch bit
   for bit, cell 0 rebuilt at 30x40 from the trajectory cache with
   ``fom.solve`` and ``solve_fom_batch`` unreachable (with the box-wide
   N-MDEIM, ``local_nmdeim=False``), and ``auto_cell_wn``'s shapes and
   floors on that cache.
13. online single-μ and evaluation phase, on phase 11's built ROM (N=15,
   S-ROM N=20, nx=1000, nt=1500), every launch counter set to 0 before
   it and read after (none: the reference computes all of it outside
   Pallas): (a) ``rom.solve(mu_val)`` (bench's center μ) in float64, cold
   and warm, within 1e-12 of the ``solve_batch([mu_val], mode="full",
   engine="lanes")`` row (tests/test_rom.py:114) and within 1e-9·scale of
   the same ROM's solve on the CPU (carried there by
   ``convert.estimator_to_arrays``); (b) the float32 solve (the
   double-word residual step) against (a), its drift and bench's
   ``serve_drift`` (bench.py:993-996, over the float64 FOM's norm); (c)
   the vmap engine at B=4 on the ROM without its convection MDEIM (the
   projection stands in, ``_resolve_engine`` → "vmap"), each row within
   1e-12 of ``solve`` on its μ; (d) ``hrom.evaluate_validation()`` and
   ``evaluate_online({"num": 2})`` in float64 in a temporary directory:
   each μ's ROM error mean under 5e-3 (tests/test_hrom.py:349), a finite
   estimator, the CSVs the reference names, and ``generate_summary``;
   with the ms of each call.

Every serving branch and the fleet report solves/s (median of the calls,
synchronized) beside the card name, where the time goes, and each
kernel's ms, twin ms and bound on the serving path's own inputs (each on
both designs, in turns). Prints a JSON line of per-kernel results (K1-K5
on the serving body with their first designs' times, the phase shares,
the register and spill report, and K1's first design's modes, ablations
and ledger; the fleet's numbers; the certification, FOM, offline build,
fleet build and online single-μ phases' numbers), then, as the last line,
``{"ok": true, "device": {...}}``. Without a CUDA device
it exits non-zero before printing any result. Imports nothing of JAX.
"""

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ATOL_REL = 5e-5      # kernel vs twin, relative to the largest |value|
#: Richardson against the LU schedule, relative to the largest |value|:
#: the reference's own limit (tests/test_pallas_online.py:664-665).
RICHARDSON_VS_LU_REL = 1e-3
SHAPES = ((50, 30, 32), (150, 10, 48))   # (W, width, N)
B = 2048
K2_BATCH = {32: 512, 48: 128}            # K2's kernel-phase batch by N
GROUP = 5
RICH_ITERS = 5                           # Richardson iterations (perf cap)
#: K1's solves in the kernel phase, each timed on both designs in turns.
K1_SOLVES = (("sub1", {"paired_lu": GROUP, "paired_mode": "sub1"}),
             ("lu", {"paired_lu": None}),
             ("richardson", {"paired_lu": GROUP, "solve_iters": RICH_ITERS}))
K1_TURN_REPS = 2     # calls per turn (first, serving, serving, first)
KERNEL_REPS = 5
RESID_REPS = 20
MODE_REPS = 3        # K1 options phase: timed calls per follower mode
LEDGER_REPS = 3      # calls per ledger variant (median)
OPTION_WINDOWS = 4   # windows of the option-vs-twin comparisons
#: Serving runs of the windowed cell: run → (stage-2 branch, calls, batch,
#: WINDOWED_SOLVE_ITERS on the instance).
SERVE_RUNS = {"fused": ("fused", 5, 2048, None),
              "matrices": ("matrices", 3, 512, None),
              "v2": ("v2", 3, 2048, None),
              "richardson": ("fused", 5, 2048, RICH_ITERS)}
BRANCH_KERNEL = {"fused": "K1", "matrices": "K2", "v2": "K3",
                 "richardson": "K1"}
KERNELS = ("K1", "K2", "K3", "K4", "K5")
GLOBAL_NT = 1500
GLOBAL_CALLS = 3
GLOBAL_REPS = 3
#: (kernel, N, B, options) of the global kernel phase.
NO_TRI_BDF1 = {"bdf2": False, "with_trilinear": False}
GLOBAL_SHAPES = (("K4", 15, 2048, {}), ("K5", 15, 2048, {}),
                 ("K5", 20, 2048, {}),
                 ("K4", 9, 2048, NO_TRI_BDF1), ("K5", 9, 2048, NO_TRI_BDF1),
                 ("K4", 15, 1000, {}), ("K5", 20, 1000, {}))
#: Sources of the serving body: no instantiation may spill.
SERVING_SOURCES = ("windowed_serving", "global_serving",
                   "resid_tables_serving", "global_tables_serving")
#: The reference's own limit between its K5 and K4 branches
#: (tests/test_rom.py:226-227).
THETA_VS_TABLES_REL = 3e-6
FLEET_CALLS = 3      # warm fleet calls after the cold one
#: (b) of the fleet phase: the cells held against the float32 lanes
#: engine (one of each shape), at the reference test's batch and limits
#: (tests/test_windowed.py:77-94).
FLEET_LANES_CELLS = (0, 5)
FLEET_LANES_B = 128
FLEET_PROBE_EXTRA = 40   # the paired-LU probe's lanes: more μ of the top cell
FLEET_PROBES_REL = 5e-6
FLEET_UN_ATOL = 5e-5
#: Phase 9, certification: (a) the global lanes engine at the serving
#: batch against the served K4/K5 at the reference's limits
#: (tests/test_rom.py:196-200); (b)-(e) float64 at the certification
#: batch, card against an explicit CPU run at the same-code limit.
CERT_B = 2048
CERT_SMALL_B = 16
CERT_PROBES_REL = 3e-5
CERT_UN_REL = 1e-4
CERT_F64_REL = 1e-9
#: The synthetic cells' grid (the flagship FOM) and the S-ROM's extra
#: modes (bench.py's BENCH_WINDOW_SROM_EXTRA default).
CERT_GRID = {"nx": 1000, "nt": 1500}
SROM_EXTRA = 8
#: (e): unequal widths (W=7 on nt=1500: 214 and 215 steps) at N=32.
CHAINED_W = 7
#: Phase 10, the FOM: the flagship piston FOM (bench.py:121-122, :145)
#: over the flagship fleet's offline batch (bench.py:113, 88 μ); (b)-(e)
#: on its first 4 μ, at the limits of the reference tests named there.
FOM_GRID = {"L0": 1.0, "nx": 1000, "tf": 1.0, "nt": 1500}
FOM_B = 88
FOM_SEED = 13
FOM_CHECK_B = 4
FOM_KEYS = ("uh", "uc", "x", "t", "probes", "nonlinear_data")
FOM_F64_REL = 1e-10
FOM_DD_DRIFT = 1e-4
FOM_DD_VS_PLAIN = 5.0
FOM_LO_REL = 1e-5
FOM_PROBE_ATOL = 1e-12
FOM_SERIAL_REL = 1e-12
# H100 SXM peaks (NVIDIA's data sheet): FP32 outside the tensor cores
# and HBM3 bandwidth, at the full 700 W power limit.
# Phase 11: bench.py's throughput profile built by the port (bench.py:117-190).
BUILD_GRID = {"nx": 1000, "nt": 1500, "tf": 1.0}
BUILD_CPU_GRID = dict(BUILD_GRID)   # (d)'s CPU build, at full width
BUILD_B = 2048
BUILD_CHECK_B = 16
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
#: Phase 12: the flagship fleet built by the port (bench.py:64-115,
#: :343-400) at full width, its depth cut: 2,2,2,2,5 training μ in cells
#: 0-4 (bench's 12,12,12,12,16) and bench's 24 in the top cell (6 left
#: its served K1 1.4% over (c)'s limit), the top cell registered (bench's
#: BENCH_REGISTER=top, bench.py:346-348; the flagship registers "auto"),
#: 4 of bench's 16 held-out μ plus its center μ (bench.py:343, :518-521).
FLEET_BUILD_GRID = {"nx": 1000, "nt": 1500, "tf": 1.0}
FLEET_BUILD_PER_CELL = (2, 2, 2, 2, 5, 24)
FLEET_BUILD_REGISTER = [5]
FLEET_BUILD_CELL_WN = ((50, 32),) * 4 + ((150, 48),) * 2
FLEET_BUILD_B = 2048
FLEET_BUILD_HELD_OUT = 4
#: (d)'s limits on the matched grid: the center μ
#: (tests/test_windowed.py:398), a registered lane
#: (tests/test_registration.py:490).
FLEET_BUILD_CENTER_REL = 1e-3
FLEET_BUILD_REGISTERED_REL = 4e-3
#: (f): cell 0 rebuilt at another shape from the trajectory cache; the
#: shape candidates and target of auto_cell_wn (bench.py:302-313).
FLEET_REBUILD_WN = (30, 40)
AUTO_WN_CANDIDATES = ((50, 32), (30, 40), (150, 48))
AUTO_WN_TARGET = 1e-5
# Phase 13: the single-μ path and the evaluation on phase 11's ROM.
SINGLE_VS_LANES = 1e-12   # tests/test_rom.py:114
F32_DRIFT_MAX = 1e-5      # a guard: a float32 solve that left float64
VMAP_B = 4
EVAL_ONLINE = 2
EVAL_ROM_MEAN = 5e-3      # tests/test_hrom.py:349


def fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(2)


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=True):
    """Mean ms per call over ``reps`` calls (after one warm-up call)."""
    if warmup:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def check(name, got, want, rel=ATOL_REL):
    scale = max(want.abs().max().item(), 1e-30)
    err = (got - want).abs().max().item()
    ok = err <= rel * scale and torch.isfinite(got).all().item()
    print(f"  {name}: max abs err {err:.3e} (scale {scale:.3e}, "
          f"limit {rel * scale:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its reference")
    return err


def rel_gap(got, want):
    """max |got − want| over max |want|."""
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)
            ).item()


def check_sweep(label, got, want):
    (p, s), (tp, ts) = got, want
    print(label)
    return max(check("probes", p, tp), check("state", s[[0, 2]], ts[[0, 2]]))


def check_global(label, got, want):
    """A global sweep (probes, uN) against its twin's; the padded probe
    rows must be exact zeros."""
    (p, u), (tp, tu) = got, want
    print(label)
    if p[:, 2:].abs().max().item() != 0.0:
        raise AssertionError(f"{label} padded probe rows are not zero")
    return max(check("probes", p, tp), check("uN", u, tu))


# ----------------------------------------------------------------------
# Work bounds: operations and bytes each kernel's call needs, from its
# inputs' shapes and the θ rows its constants use (no loop of these
# kernels ends early).
# ----------------------------------------------------------------------
def lu_fmas(NP):
    """FMAs of one lane's pivot-free LU of an NP×NP matrix and its two
    triangular solves: the least a solve needs (no explicit inverse)."""
    return sum((NP - k - 1) * (NP - k) for k in range(NP)) + NP * NP


def live_rows(table, NP, n):
    """θ rows that a constant table (θ on its last axis; its rows the NP²
    entries (i, j) of MN or KL, or the NP entries of fN) feeds into the
    real n×n block (the n real rows of fN). A θ row whose column is zero
    there is no work: a row that pads the extent to a multiple of 8, or
    the constant-1 row that carries only the padded diagonal. The windowed
    kernels count the whole padded block (n = NP, see step_fmas)."""
    k = table.shape[-1]
    if table.shape[-2] == NP * NP:
        t = table.reshape(-1, NP, NP, k)[:, :n, :n]
    else:
        t = table.reshape(-1, NP, k)[:, :n]
    return int((t != 0).reshape(-1, k).any(dim=0).sum())


def step_fmas(NP, km, kk, kf, with_trilinear, solve):
    """FMAs of one lane's residual BDF step with each operator formed once
    from its live θ rows (live_rows): MN = Bm·θm and KL = Bk·θk
    (NP²·(km + kk)), fN = Bf·θf (NP·kf), the trilinear NN = T0·pred and
    dtS (NP³ + NP²), KN, MN·d and dtS·pred (3·NP²), the solve, and the
    probes (8·NP). K1, K2 and K3 compute this same step; K2 reads MN, KL
    and fN instead (km = kk = kf = 0)."""
    tri = NP ** 3 + NP * NP if with_trilinear else 0
    return (NP * NP * (km + kk) + NP * kf + tri + 3 * NP * NP + solve
            + 8 * NP)


def bound(flops, nbytes):
    """(least ms, what sets it) against the card's FP32 and HBM peaks."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


#: NP² multiples of a paired-LU follower's solve, by mode: one
#: substitution is NP² (forward and back), one residual matvec NP².
FOLLOWER_NP2 = {"sub1": 3, "warm1": 2, "warm2": 4, "warmx": 2, "inv1": 3,
                "inv2": 5}


def solve_fmas(role, mode, NP):
    """FMAs of one lane's solve in a step of ``role`` under paired-LU
    ``mode``: a follower per :data:`FOLLOWER_NP2` (a warmx follower also
    forms 2·δₙ₋₁ − δₙ₋₂, NP), an inv leader's inversion and matvec
    (NP³ + NP²), otherwise an LU with its substitutions."""
    if role == "follow":
        return FOLLOWER_NP2[mode] * NP * NP + (NP if mode == "warmx" else 0)
    if role == "lead" and mode in ("inv1", "inv2"):
        return NP ** 3 + NP * NP
    return lu_fmas(NP)


def k1_bound(args, kw):
    """K1 over a whole sweep. A paired-LU step solves as
    :func:`solve_fmas` counts for its role and mode. The Richardson solve
    (``solve_iters`` = n) takes 2n NP² matvecs per step, and per window
    K̄'s build from the live θ rows and the trilinear block, its inverse
    (NP³, the least an inversion needs) and the δ transfer (NP²). The
    window transfers are two dd matvecs through Tp[w] (~10 operations per
    entry)."""
    from romtime_tpu_torch.ops.windowed_fused import step_roles

    TH, Bmk, BfT = args[0], args[1], args[4]
    nt, _K8, Bn = TH.shape
    W, NP = args[6].shape[0], args[6].shape[2]       # VE (W, P, NP)
    width = nt // W
    iters = kw.get("solve_iters")
    group = kw.get("paired_lu") or 0
    group = group if group >= 2 and kw["n_real"] > 20 else 0
    mode = kw.get("paired_mode", "sub1")
    roles = step_roles(kw.get("period") or width, group)
    solve = sum(solve_fmas(r, mode, NP) for r in roles) / len(roles)
    km8, kk8 = kw["km8"], kw["kk8"]                  # Bmk (W, kfold, NP²)
    km = live_rows(Bmk[:, :km8].transpose(1, 2), NP, NP)
    kk = live_rows(Bmk[:, km8:km8 + kk8].transpose(1, 2), NP, NP)
    per_window = 2 * 10 * NP * NP
    if group and mode in ("warm1", "warm2", "warmx"):     # δ transfers
        per_window += NP * NP * (2 if mode == "warmx" else 1)
    if iters:
        solve = 2 * iters * NP * NP
        tri = NP if kw["with_trilinear"] else 0
        per_window += NP * NP * (km + kk + tri) + NP ** 3 + NP * NP
    per_step = step_fmas(NP, km, kk, live_rows(BfT.transpose(1, 2), NP, NP),
                         kw["with_trilinear"], solve)
    flops = 2 * Bn * (nt * per_step + W * per_window)
    nbytes = 4 * (TH.numel() + sum(a.numel() for a in args[1:8])
                  + Bn + 2 * 4 * NP * Bn + nt * 8 * Bn)
    return bound(flops, nbytes)


def k2_bound(args, kw):
    MN, _KL, fN, g = args[:4]
    nt, NP, _, Bn = MN.shape
    per_step = step_fmas(NP, 0, 0, 0, kw["with_trilinear"], lu_fmas(NP))
    flops = 2 * Bn * nt * per_step
    nbytes = 4 * (2 * MN.numel() + fN.numel() + 2 * g.numel()
                  + (NP ** 3 if kw["with_trilinear"] else 0) + 8 * NP + Bn
                  + 2 * 4 * NP * Bn)
    return bound(flops, nbytes)


def k3_bound(args, kw):
    THm, THk, THf, g, Bm, Bk, Bf = args[:7]
    nt, _km8, Bn = THm.shape
    NP = Bf.shape[0]
    per_step = step_fmas(NP, live_rows(Bm, NP, NP), live_rows(Bk, NP, NP),
                         live_rows(Bf, NP, NP), kw["with_trilinear"],
                         lu_fmas(NP))
    flops = 2 * Bn * nt * per_step
    nbytes = 4 * (THm.numel() + THk.numel() + THf.numel() + 2 * g.numel()
                  + Bm.numel() + Bk.numel() + Bf.numel()
                  + (NP ** 3 if kw["with_trilinear"] else 0) + 8 * NP + Bn
                  + 2 * 4 * NP * Bn)
    return bound(flops, nbytes)


def global_step_fmas(n, km, kk, kf, with_trilinear):
    """FMAs of one lane's plain-f32 global BDF step on n real rows (the
    padded rows and columns hold zeros and the identity, no work): the
    operators MN = Bm·θm, KL = Bk·θk (n²·(km + kk)) and fN = Bf·θf (n·kf)
    over their live θ rows (live_rows) when they are formed, the
    trilinear NN = T0·u* (n³) and its scaled add (n²), KN and the
    MN·combo product (2·n²), a solve (LU and its two substitutions) and
    the two real probe rows (2·n). K4 reads MN, KL and fN instead
    (km = kk = kf = 0)."""
    tri = n ** 3 + n * n if with_trilinear else 0
    return (n * n * (km + kk) + n * kf + tri + 2 * n * n + lu_fmas(n)
            + 2 * n)


def k4_bound(args, kw):
    MN, _KL, fN, g = args[:4]
    nt, NP, _, Bn = MN.shape
    per_step = global_step_fmas(kw["n_real"], 0, 0, 0, kw["with_trilinear"])
    flops = 2 * Bn * nt * per_step
    nbytes = 4 * (2 * MN.numel() + fN.numel() + 2 * g.numel()
                  + (NP ** 3 if kw["with_trilinear"] else 0) + 8 * NP + Bn
                  + NP * Bn)
    return bound(flops, nbytes)


def k5_bound(args, kw):
    THm, THk, THf, g, Bm, Bk, Bf = args[:7]
    nt, _km8, Bn = THm.shape
    NP = Bf.shape[0]
    n = kw["n_real"]
    per_step = global_step_fmas(n, live_rows(Bm, NP, n), live_rows(Bk, NP, n),
                                live_rows(Bf, NP, n), kw["with_trilinear"])
    flops = 2 * Bn * nt * per_step
    nbytes = 4 * (THm.numel() + THk.numel() + THf.numel() + 2 * g.numel()
                  + Bm.numel() + Bk.numel() + Bf.numel()
                  + (NP ** 3 if kw["with_trilinear"] else 0) + 8 * NP + Bn
                  + NP * Bn)
    return bound(flops, nbytes)


#: The bound of each global kernel.
GLOBAL_BOUND = {"K4": k4_bound, "K5": k5_bound}


# ----------------------------------------------------------------------
# Kernel phase
# ----------------------------------------------------------------------
def first_windows(args, kw, n):
    """K1's inputs cut to their first ``n`` windows."""
    width = kw["widths"][0]
    return ((args[0][:n * width], *(a[:n] for a in args[1:8]), args[8],
             args[9]), dict(kw, widths=(width,) * n))


def turns(a, b, args, kw, reps):
    """Two designs on the same inputs in turns (a, b, b, a): (a's ms, b's
    ms, a's outputs, b's outputs), each ms the mean of its two turns."""
    fa = lambda: a(*args, **kw)    # noqa: E731
    fb = lambda: b(*args, **kw)    # noqa: E731
    a1, _ = cuda_ms(fa, reps)
    b1, got_b = cuda_ms(fb, reps)
    b2, _ = cuda_ms(fb, reps, warmup=False)
    a2, got_a = cuda_ms(fa, reps, warmup=False)
    return (a1 + a2) / 2, (b1 + b2) / 2, got_a, got_b


def k1_turns(k1, args, kw, reps):
    """K1's first and serving designs on the same inputs in turns (first,
    serving, serving, first): (serving ms, first ms, serving's outputs,
    the first's outputs)."""
    first_ms, ms, ref, got = turns(k1._first_design_sweep,
                                   k1.online_sweep_windowed_fused, args, kw,
                                   reps)
    return ms, first_ms, got, ref


def theta_entries(mods, name):
    """(serving wrapper, first-design entry, twin, split twin) of K3 or
    K5."""
    if name == "K3":
        rs = mods["rs"]
        return (rs.online_sweep_theta_pallas_v2, rs._first_design_theta_v2,
                rs.theta_sweep_v2_reference, rs.theta_sweep_v2_split)
    gs = mods["gs"]
    return (gs.online_sweep_theta_pallas, gs._first_design_theta,
            gs.theta_sweep_reference, gs.theta_sweep_split)


def theta_designs(mods, name, args, kw, reps, label, check_fn):
    """K3 or K5 (``name``) on both designs in turns (serving, first,
    first, serving), the serving body held against the first design, the
    twin and the split twin: (a row {"ms", "first_design_ms", "plain_ms",
    "max_abs_err"} (plain_ms: the twin's), the twin's outputs)."""
    serve, first, twin, split = theta_entries(mods, name)
    ms, first_ms, got, ref = turns(serve, first, args, kw, reps)
    err = check_fn(f"{label}, serving body vs its first design:", got, ref)
    del ref
    plain_ms, want = cuda_ms(lambda: twin(*args, **kw), 1, warmup=False)
    err = max(err, check_fn(f"{label}, serving body vs twin:", got, want))
    err = max(err, check_fn(f"{label}, serving body vs split twin:", got,
                            split(*args, **kw)))
    print(f"  serving body {ms:.3f} ms, first design {first_ms:.3f} "
          f"({first_ms / ms:.2f}×), twin {plain_ms:.1f} ms")
    return dict(ms=ms, first_design_ms=first_ms, plain_ms=plain_ms,
                max_abs_err=err), want


def table_entries(mods, name):
    """(serving wrapper, first-design entry, twin, split twin) of K2 or
    K4."""
    if name == "K2":
        rs = mods["rs"]
        return (rs.online_sweep_pallas_v2, rs._first_design_v2,
                rs.sweep_v2_reference, rs.sweep_v2_split)
    gs = mods["gs"]
    return (gs.online_sweep_pallas, gs._first_design_tables,
            gs.sweep_reference, gs.sweep_split)


def table_designs(mods, name, args, kw, reps, label, check_fn,
                  lanes_sweep=False):
    """K2 or K4 (``name``) on both designs in turns (serving, first, first,
    serving): the serving body on lane-major tables (converted once from
    the reference layout of ``args``, the conversion timed apart), the
    first design on ``args``; the serving body held against the first
    design, the twin and the split twin, and with ``lanes_sweep`` (K2)
    timed at every lane tile it takes. Returns (a row {"ms", "first_design_ms",
    "plain_ms", "max_abs_err", "conversion_ms", "lanes"[, "lanes_ms"]},
    the twin's outputs, the lane-major args and keywords)."""
    rs = mods["rs"]
    serve, first, twin, split = table_entries(mods, name)
    conversion_ms, lm = cuda_ms(lambda: rs.lane_major(*args[:3]), reps)
    largs, lkw = (*lm, *args[3:]), dict(kw, lane_major=True)
    del lm
    ms, first_ms, got, ref = turns(lambda *_a, **_k: serve(*largs, **lkw),
                                   lambda *_a, **_k: first(*args, **kw),
                                   (), {}, reps)
    err = check_fn(f"{label}, serving body vs its first design:", got, ref)
    del ref
    plain_ms, want = cuda_ms(lambda: twin(*args, **kw), 1, warmup=False)
    err = max(err, check_fn(f"{label}, serving body vs twin:", got, want))
    err = max(err, check_fn(f"{label}, serving body vs split twin:", got,
                            split(*largs, **lkw)))
    NP, Bn = args[5].shape[-1], args[3].shape[-1]
    row = dict(ms=ms, first_design_ms=first_ms, plain_ms=plain_ms,
               conversion_ms=conversion_ms,
               lanes=rs.table_lanes(Bn, NP, got[0].device))
    print(f"  serving body {ms:.3f} ms ({row['lanes']} lanes a block), "
          f"first design {first_ms:.3f} ({first_ms / ms:.2f}×), twin "
          f"{plain_ms:.1f} ms; layout conversion {conversion_ms:.3f} ms")
    if lanes_sweep:
        row["lanes_ms"] = {}
        for tl in rs.TABLE_LANES:
            if tl > rs.table_lanes_max(NP):
                continue
            row["lanes_ms"][tl], out = cuda_ms(
                lambda: rs._v2_lanes(*largs, lanes=tl, **lkw), reps)
            err = max(err, check_fn(f"{label}, serving body at {tl} lanes a "
                                    f"block vs twin:", out, want))
            print(f"  serving body at {tl} lanes a block "
                  f"{row['lanes_ms'][tl]:.3f} ms")
    row["max_abs_err"] = err
    return row, want, largs, lkw


def print_split(what, split):
    """A phase split's lines (kernel_ledger.split_lines) under ``what``."""
    from romtime_tpu_torch.kernel_ledger import split_lines

    print(what)
    for line in split_lines(split):
        print("  " + line)


def kernel_phase(mods, dev, power, errs, rich_errs):
    from romtime_tpu_torch.kernel_ledger import body_phase_split, phase_split

    k1, synth = mods["k1"], mods["synth"]
    rows, splits = [], {}
    for W, width, N in SHAPES:
        shape = f"{W}x{N}"
        args, kw = synth.kernel_tables(N, W, width, B, seed=W, device=dev)
        lu_ms = lu_probes = None
        for solve, opts in K1_SOLVES:
            kws = dict(kw, **opts)
            label = (f"K1 {shape} width={width} B={B} {solve} on {power}")
            ms, first_ms, got, ref = k1_turns(k1, args, kws, K1_TURN_REPS)
            err = check_sweep(f"{label}, serving design vs the first design "
                              f"(whole sweep):", got, ref)
            a4, kw4 = first_windows(args, kws, OPTION_WINDOWS)
            err = max(err, check_sweep(
                f"{label}, serving design vs twin (first {OPTION_WINDOWS} "
                f"windows):", k1.online_sweep_windowed_fused(*a4, **kw4),
                k1.windowed_fused_reference(*a4, **kw4)))
            row = dict(kernel="K1", solve=solve, shape=shape, B=B, ms=ms,
                       first_design_ms=first_ms)
            if solve != "lu":
                # The twin over the whole sweep (its time is plain_ms).
                row["plain_ms"], want = cuda_ms(
                    lambda: k1.windowed_fused_reference(*args, **kws), 1,
                    warmup=False)
                err = max(err, check_sweep(f"{label}, serving design vs "
                                           f"twin (whole sweep):", got, want))
                del want
            errs["K1"].append(err)
            if solve == "richardson":
                rich_errs.append(err)
            bms, by = k1_bound(args, kws)
            row.update(bound_ms=bms, bound_by=by, max_abs_err=err)
            extra = ""
            if solve == "lu":
                lu_ms, lu_probes = ms, got[0]
            elif solve == "richardson":
                row["vs_lu_rel"] = ((got[0] - lu_probes).abs().max()
                                    / lu_probes.abs().max()).item()
                extra = (f"; {ms / lu_ms:.3f}× the per-step LU's "
                         f"{lu_ms:.3f}; probes differ from the per-step "
                         f"LU's by {row['vs_lu_rel']:.3e} of their scale")
            print(f"  serving design {ms:.3f} ms/sweep, first design "
                  f"{first_ms:.3f} ({first_ms / ms:.2f}×), "
                  + (f"twin {row['plain_ms']:.1f}, " if "plain_ms" in row
                     else "") + f"bound {bms:.3f} ms ({by}){extra}")
            rows.append(row)
            del got, ref
        split = phase_split(args, kw, reps=K1_TURN_REPS)
        print_split(f"K1 serving design phase clocks {shape} B={B} on "
                    f"{power}:", split)
        splits[shape] = split
        del lu_probes
        step0 = (W // 2) * width
        for name, theta, Bk, bnd in (("K2", False, K2_BATCH[N], k2_bound),
                                     ("K3", True, B, k3_bound)):
            args, kw = synth.resid_tables(N, width, Bk, seed=W + 1,
                                          device=dev, theta=theta,
                                          step0=step0)
            label = (f"{name} {W}x{N} one window launch (width={width}, "
                     f"step0={step0}) B={Bk} on {power}")
            bms, by = bnd(args, kw)
            if theta:
                row, _want = theta_designs(mods, name, args, kw, RESID_REPS,
                                           label, check_sweep)
                sargs, skw = args, kw
            else:
                row, _want, sargs, skw = table_designs(
                    mods, name, args, kw, RESID_REPS, label, check_sweep,
                    lanes_sweep=N == 32)
            del args, _want
            # A launch takes ~0.3-1.5 ms: many calls steady the medians.
            split = body_phase_split(name, sargs, skw, reps=RESID_REPS)
            print_split(f"{name} serving body phase clocks {shape} B={Bk} "
                        f"on {power}:", split)
            row["phase_split"] = split["lu"]
            del sargs
            print(f"  bound {bms:.4f} ms ({by})")
            errs[name].append(row["max_abs_err"])
            rows.append(dict(kernel=name, shape=f"{W}x{N}", B=Bk,
                             bound_ms=bms, bound_by=by, **row))
    return rows, splits


def k1_options_phase(mods, dev, power):
    """Every paired-LU follower mode and every ablation of K1, at both
    windowed shapes on the kernel-phase tables: each mode's time, bound
    and probe gap to the per-step LU and to sub1 over a whole sweep; each
    mode and each ablation (with the LU schedule and with Richardson)
    against its twin on the first OPTION_WINDOWS windows; the cost ledger
    (romtime_tpu_torch/kernel_ledger.py). Returns (modes, ablations,
    ledgers)."""
    from romtime_tpu_torch.kernel_ledger import kernel_ledger, ledger_lines

    k1, synth = mods["k1"], mods["synth"]
    wrapper, twin = k1.online_sweep_windowed_fused, k1.windowed_fused_reference
    modes, ablations, ledgers = [], [], {}
    for W, width, N in SHAPES:
        shape = f"{W}x{N}"
        args, kw = synth.kernel_tables(N, W, width, B, seed=W, device=dev)
        tri_off = synth.kernel_tables(N, W, width, B, seed=W, device=dev,
                                      with_trilinear=False)
        t0 = time.perf_counter()
        ledger = kernel_ledger(args, kw, no_trilinear=tri_off,
                               reps=LEDGER_REPS)
        del tri_off
        print(f"K1 cost ledger {shape} width={width} B={B} on {power} "
              f"({time.perf_counter() - t0:.1f} s):")
        for line in ledger_lines(ledger, B):
            print("  " + line)
        ledgers[shape] = ledger

        lu_p = wrapper(*args, **dict(kw, paired_lu=None))[0]
        sub1_p = wrapper(*args, **dict(kw, paired_lu=GROUP))[0]
        scale = lu_p.abs().max().item()
        lu_ms = ledger["lu"]["ms_per_sweep"]["full"]
        for mode in k1.PAIRED_MODES[1:]:
            kwm = dict(kw, paired_lu=GROUP, paired_mode=mode)
            ms, got = cuda_ms(lambda: wrapper(*args, **kwm), MODE_REPS)
            gap_lu = (got[0] - lu_p).abs().max().item() / scale
            gap_sub1 = (got[0] - sub1_p).abs().max().item() / scale
            bms, by = k1_bound(args, kwm)
            del got
            a4, kw4 = first_windows(args, kwm, OPTION_WINDOWS)
            err = check_sweep(f"K1 {shape} {mode} G={GROUP}, first "
                              f"{OPTION_WINDOWS} windows vs twin:",
                              wrapper(*a4, **kw4), twin(*a4, **kw4))
            print(f"  {mode}: {ms:.3f} ms/sweep ({ms / lu_ms:.3f}× the "
                  f"per-step LU's {lu_ms:.3f}), bound {bms:.3f} ms ({by}); "
                  f"probes differ from the per-step LU's by {gap_lu:.3e} "
                  f"and from sub1's by {gap_sub1:.3e} of their scale")
            modes.append(dict(shape=shape, mode=mode, group=GROUP, ms=ms,
                              bound_ms=bms, bound_by=by, max_abs_err=err,
                              gap_vs_lu_rel=gap_lu, gap_vs_sub1_rel=gap_sub1))
        del lu_p, sub1_p
        for ablate in k1.ABLATE_MODES:
            for iters in (None, RICH_ITERS):
                a4, kw4 = first_windows(args, dict(
                    kw, ablate=ablate, solve_iters=iters), OPTION_WINDOWS)
                err = check_sweep(f"K1 {shape} ablate={ablate} solve_iters="
                                  f"{iters}, first {OPTION_WINDOWS} windows "
                                  f"vs twin:", wrapper(*a4, **kw4),
                                  twin(*a4, **kw4))
                ablations.append(dict(shape=shape, ablate=ablate,
                                      solve_iters=iters, max_abs_err=err))
        del args
        torch.cuda.empty_cache()
    return modes, ablations, ledgers


def global_kernel_phase(mods, dev, power, errs):
    from romtime_tpu_torch.kernel_ledger import body_phase_split

    synth = mods["synth"]
    rows = []
    for name, N, Bn, options in GLOBAL_SHAPES:
        bnd = GLOBAL_BOUND[name]
        args, kw = synth.global_tables(N, GLOBAL_NT, Bn, seed=N, device=dev,
                                       theta=name == "K5", **options)
        label = (f"{name} N={N} nt={GLOBAL_NT} B={Bn}"
                 + (", BDF-1 without the trilinear term" if options else "")
                 + f" on {power}")
        bms, by = bnd(args, kw)
        if name == "K5":
            row, _want = theta_designs(mods, name, args, kw, GLOBAL_REPS,
                                       label, check_global)
            sargs, skw = args, kw
        else:
            row, _want, sargs, skw = table_designs(
                mods, name, args, kw, GLOBAL_REPS, label, check_global)
        del _want, args
        if (name, N, Bn) in (("K4", 15, B), ("K5", 20, B)):
            split = body_phase_split(name, sargs, skw, reps=GLOBAL_REPS)
            print_split(f"{name} serving body phase clocks N={N} B={Bn} on "
                        f"{power}:", split)
            row["phase_split"] = split["lu"]
        del sargs
        print(f"  bound {bms:.4f} ms ({by})")
        errs[name].append(row["max_abs_err"])
        rows.append(dict(kernel=name, shape=f"N{N}", B=Bn, options=options,
                         bound_ms=bms, bound_by=by, **row))
        torch.cuda.empty_cache()
    return rows


# ----------------------------------------------------------------------
# Serving phase
# ----------------------------------------------------------------------
@contextlib.contextmanager
def twins_in_engine(engine, rs):
    """The engine's per-window sweeps call the K2/K3 twins instead of the
    kernels (the comparison run of the serving phase)."""
    saved = engine.online_sweep_pallas_v2, engine.online_sweep_theta_pallas_v2
    engine.online_sweep_pallas_v2 = rs.sweep_v2_reference
    engine.online_sweep_theta_pallas_v2 = rs.theta_sweep_v2_reference
    try:
        yield
    finally:
        (engine.online_sweep_pallas_v2,
         engine.online_sweep_theta_pallas_v2) = saved


@contextlib.contextmanager
def branch_scope(branch):
    """The kernel switch of ``branch`` (the batch size picks between the
    materialized tables and the θ-streaming kernels)."""
    saved = os.environ.get("ROMTIME_WINDOWED_KERNEL")
    if branch == "v2":
        os.environ["ROMTIME_WINDOWED_KERNEL"] = "v2"
    else:
        os.environ.pop("ROMTIME_WINDOWED_KERNEL", None)
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("ROMTIME_WINDOWED_KERNEL", None)
        else:
            os.environ["ROMTIME_WINDOWED_KERNEL"] = saved


def counters(mods):
    """The launch counters of K1-K5, in that order."""
    return (mods["k1"].online_sweep_windowed_fused,
            mods["rs"].online_sweep_pallas_v2,
            mods["rs"].online_sweep_theta_pallas_v2,
            mods["gs"].online_sweep_pallas,
            mods["gs"].online_sweep_theta_pallas)


def design_counts(mods):
    """(serving, first-design) launches of K1-K5."""
    return {name: (c.serving_launches, c.first_design_launches)
            for name, c in zip(KERNELS, counters(mods))}


def serve_calls(rom, batches, mods, engine):
    """Warm up, zero every launch counter, serve the batches one call at
    a time (synchronized), read the counters: (launches of K1-K5, K1's
    Richardson launches, {K1-K5: (serving-design, first-design)
    launches}, outputs, call seconds)."""
    k1 = mods["k1"].online_sweep_windowed_fused
    rom.solve_batch(batches[0], mode="probes", engine=engine,
                    probe_reduce="mean")
    torch.cuda.synchronize()
    for c in counters(mods):
        c.launches = c.serving_launches = c.first_design_launches = 0
    k1.richardson_launches = 0
    times, outs = [], []
    for mus in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(rom.solve_batch(mus, mode="probes", engine=engine,
                                    probe_reduce="mean"))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return ([c.launches for c in counters(mods)], k1.richardson_launches,
            design_counts(mods), outs, times)


def check_served(outs, Bb, N):
    for out in outs:
        probes, uN = out["probes"], out["uN_final"]
        if probes.shape != (Bb, 2) or uN.shape != (Bb, N):
            raise AssertionError(f"unexpected output shapes {probes.shape}, "
                                 f"{uN.shape}")
        if not (torch.isfinite(torch.as_tensor(probes)).all()
                and torch.isfinite(torch.as_tensor(uN)).all()):
            raise AssertionError("non-finite serving outputs")


def call_info(Bb, times):
    seconds = statistics.median(times)
    return dict(B=Bb, calls=len(times), solves_per_s=Bb / seconds,
                serve_ms_median=seconds * 1e3, serve_ms_min=min(times) * 1e3,
                serve_ms_max=max(times) * 1e3)


def serve_branch(rom, run, batches, mods, power):
    """Drive one serving run of :data:`SERVE_RUNS`: its solve setting on
    the instance, then warm up, zero every launch counter, serve the
    batches one call at a time (synchronized), read the counters."""
    from romtime_tpu_torch.rom.engines.windowed_fused import stage2_branch

    branch, _calls, _B, iters = SERVE_RUNS[run]
    rom.WINDOWED_SOLVE_ITERS = iters
    W = rom.windows.n_windows
    nt = int(rom.fom.domain[rom.fom.NT])
    Bb = len(batches[0])
    with branch_scope(branch):
        got = stage2_branch(nt, mods["k1"].pad_dim(rom.windows.N), Bb,
                            rom.precompute_choice)
        if got != branch:
            raise AssertionError(f"B={Bb} routes to {got}, not {branch}")
        launches, rich, designs, outs, times = serve_calls(
            rom, batches, mods, "windowed-pallas")
    calls = len(batches)
    want = {"fused": [calls, 0, 0, 0, 0], "matrices": [0, W * calls, 0, 0, 0],
            "v2": [0, 0, W * calls, 0, 0]}[branch]
    # Every run launches the serving designs only.
    want_designs = {k: (n, 0) for k, n in zip(KERNELS, want)}
    want_rich = calls if iters else 0
    info = call_info(Bb, times)
    print(f"serving, {run} run ({branch} branch, solve_iters {iters}): "
          f"{calls} calls of {Bb} μ, median "
          f"{info['serve_ms_median']:.1f} ms per call (min "
          f"{info['serve_ms_min']:.1f}, max {info['serve_ms_max']:.1f}) = "
          f"{info['solves_per_s']:.1f} solves/s (prep + sweep + fetch, "
          f"synchronized) on {power}; launches K1-K5 {launches}, K1 "
          f"Richardson {rich}, (serving design, first design) {designs}")
    if launches != want or rich != want_rich or designs != want_designs:
        raise AssertionError(f"{run} run launched {launches} (Richardson "
                             f"{rich}, designs {designs}), expected {want} "
                             f"({want_rich}, {want_designs})")
    check_served(outs, Bb, rom.windows.N)
    return launches, outs, info


def served_vs(name, out, probes, uN, N, dev):
    """Served (time-mean probes, uN_final) against a sweep's outputs
    (probes (nt, 8, B), uN (NP, B))."""
    print(name)
    want_p = probes[:, :2, :].mean(dim=0).T
    want_u = uN[:N, :].T
    return max(check("probes (time mean)",
                     torch.as_tensor(out["probes"], device=dev), want_p),
               check("uN_final", torch.as_tensor(out["uN_final"],
                                                 device=dev), want_u))


def pivot_line(rom):
    """The pivot-free guard's result on a served cell."""
    if rom.global_serving is None:
        return "pivot-free guard: skipped (no global basis)"
    return (f"pivot-free guard: cond2(K_N) = {rom._pivot_cert:.6g} over the "
            f"μ-box corners and center at 4 times (limit "
            f"{rom.PIVOT_FREE_COND_BOUND:.0e}/1.3)")


def serving_phase(mods, dev, power, errs, rich_errs):
    import romtime_tpu_torch.rom.engines.windowed_fused as engine

    k1, rs, synth = mods["k1"], mods["rs"], mods["synth"]
    t0 = time.perf_counter()
    rom = synth.synthetic_cell(seed=0, device=dev)
    tables = rom._windowed_tables()
    win, fom = rom.windows, rom.fom
    W = win.n_windows
    print(f"serving cell 50x32 (nx=1000, nt=1500) built in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rom.WINDOWED_SOLVE_ITERS = "auto"
    decision = rom._windowed_solve_iters()
    rho = win._auto_iters_rho_value
    print(f"solve policy on the 50x32 cell: measured ρ = {rho:.6g} → "
          f"{'LU' if decision is None else f'{decision} Richardson iterations'}"
          f" ({time.perf_counter() - t0:.1f} s on the host, float64)")
    batches = [synth.synthetic_mus(B, seed=1 + r)
               for r in range(max(c for _b, c, _n, _i in SERVE_RUNS.values()))]
    runs, kernels = {}, {}
    for run, (_branch, calls, Bb, _iters) in SERVE_RUNS.items():
        runs[run] = serve_branch(
            rom, run, [mus[:Bb] for mus in batches[:calls]], mods, power)
    print(pivot_line(rom))

    # The last batch of each run again, kernels against twins on the
    # card, from one prep; then where the run's time goes.
    for run, (_l, outs, info) in runs.items():
        branch, _calls, _Bb, iters = SERVE_RUNS[run]
        rom.WINDOWED_SOLVE_ITERS = iters
        kname = BRANCH_KERNEL[run]
        mus = batches[info["calls"] - 1][:info["B"]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prepped = rom.prep(mus)
        torch.cuda.synchronize()
        info["prep_ms"] = (time.perf_counter() - t0) * 1e3
        (THm, THk, THf, g, b0), kw = engine.window_inputs(fom, win,
                                                             prepped)
        if branch == "fused":
            args, kwf = engine.sweep_inputs(fom, win, prepped, tables,
                                            rom.windowed_solve())
            ms, first_ms, got, ref = k1_turns(k1, args, kwf, KERNEL_REPS)
            errs["K1"].append(check_sweep(
                f"{run} run: K1's serving design vs its first design on the "
                f"serving inputs:", got, ref))
            del ref
            plain_ms, want = cuda_ms(lambda: k1.windowed_fused_reference(
                *args, **kwf), 1, warmup=False)
            info["sweep_ms"] = ms
            bms, by = k1_bound(args, kwf)
            print(f"  K1 on the serving inputs (solve_iters "
                  f"{kwf['solve_iters']}, period {kwf['period']}): serving "
                  f"design {ms:.3f} ms/sweep, first design {first_ms:.3f} "
                  f"(in turns), twin {plain_ms:.1f} ms/sweep, bound "
                  f"{bms:.3f} ms ({by}) on {power}")
            kernels[run] = dict(ms=ms, first_design_ms=first_ms,
                                plain_ms=plain_ms, bound_ms=bms, bound_by=by)
        else:
            sweep = (engine.sweep_materialized if branch == "matrices"
                     else engine.sweep_theta_v2)
            info["sweep_ms"], got = cuda_ms(
                lambda: sweep(fom, win, prepped, tables), 3)
            with twins_in_engine(engine, rs):
                _ms, want = cuda_ms(lambda: sweep(fom, win, prepped, tables),
                                    1, warmup=False)
            # One window launch on the serving inputs (window W/2).
            w = W // 2
            a, b = int(win.bounds[w]), int(win.bounds[w + 1])
            state = THm.new_zeros((4, tables["VE"].shape[2], THm.shape[2]))
            if branch == "matrices":
                # The engine's lane-major product, and the reference
                # layout's einsum it replaced, on the same window.
                info["einsum_ms_per_window"], ops = cuda_ms(
                    lambda: engine.window_operators(tables, w, THm, THk, THf,
                                                    a, b), RESID_REPS)
                info["materialize_ms_per_window"], lops = cuda_ms(
                    lambda: engine.window_operators_lanes(
                        tables, w, THm, THk, THf, a, b), RESID_REPS)
                gap = max(rel_gap(x, y) for x, y in
                          zip(lops, rs.lane_major(*ops)))
                print(f"  window {w}'s tables: lane-major product "
                      f"{info['materialize_ms_per_window']:.3f} ms, the "
                      f"reference layout's einsum "
                      f"{info['einsum_ms_per_window']:.3f} ms; they differ "
                      f"by {gap:.3e} of their scale")
                del lops
                wargs = (*ops, g[a:b], tables["T0"][w], tables["VE"][w], b0,
                         state)
                name, bnd = "K2", k2_bound
            else:
                wargs = (THm[a:b], THk[a:b], THf[a:b], g[a:b],
                         tables["Bm"][w], tables["Bk"][w], tables["Bf"][w],
                         tables["T0"][w], tables["VE"][w], b0, state)
                name, bnd = "K3", k3_bound
            wkw = dict(kw, step0=a)
            label = (f"{name} on the serving inputs of window {w} "
                     f"(B={info['B']})")
            if name == "K3":
                wkw.update(engine.live_rows(tables))
                row, _want = theta_designs(mods, name, wargs, wkw,
                                           RESID_REPS, label, check_sweep)
                # The wrapper's per-launch operand prep (the merged θ
                # table, the padded fold and VE) alone.
                row["operand_prep_ms"], _ops = cuda_ms(
                    lambda: rs.serving_operands(
                        *wargs[:9], kw["with_trilinear"]), RESID_REPS)
                print(f"  of it the serving body's operand prep (merged θ, "
                      f"padded fold) {row['operand_prep_ms']:.3f} ms")
            else:
                row, _want, _l, _k = table_designs(
                    mods, name, wargs, wkw, RESID_REPS, label, check_sweep)
            errs[name].append(row.pop("max_abs_err"))
            bms, by = bnd(wargs, wkw)
            kernels[name] = dict(row, bound_ms=bms, bound_by=by)
            info["kernel_ms_per_window"] = row["ms"]
        run_errs = [check_sweep(
            f"{run} run sweep vs its twins (B={info['B']}):", got, want),
            served_vs(f"{run} run served outputs vs its twins' sweep:",
                      outs[-1], want[0], want[1][0], rom.windows.N, dev)]
        errs[kname] += run_errs
        if iters:
            rich_errs += run_errs
        rest = info["serve_ms_median"] - info["prep_ms"] - info["sweep_ms"]
        print(f"  breakdown: prep {info['prep_ms']:.1f} ms, sweep "
              f"{info['sweep_ms']:.1f} ms, the rest (probe mean, fetch) "
              f"{rest:.1f} ms")
        if branch != "fused":
            print(f"  per window: {name} {info['kernel_ms_per_window']:.3f}"
                  f" ms" + (f", materializing MN/KL/fN lane-major "
                            f"{info['materialize_ms_per_window']:.3f} ms"
                            if branch == "matrices" else "")
                  + f"; {W} windows")

    # K2 and K3 against K1 on the same μ (the kernels' tolerance), and
    # the Richardson run against the LU schedule (the reference's limit).
    k1_outs = runs["fused"][1]
    for run, rel in (("matrices", ATOL_REL), ("v2", ATOL_REL),
                     ("richardson", RICHARDSON_VS_LU_REL)):
        _l, outs, info = runs[run]
        ref = k1_outs[info["calls"] - 1]
        Bb = info["B"]
        print(f"{run} run vs the fused LU run on the same {Bb} μ:")
        err = max(
            check("probes (time mean)", torch.as_tensor(outs[-1]["probes"]),
                  torch.as_tensor(ref["probes"][:Bb]), rel=rel),
            check("uN_final", torch.as_tensor(outs[-1]["uN_final"]),
                  torch.as_tensor(ref["uN_final"][:Bb]), rel=rel))
        if run != "richardson":      # another solve, not a kernel error
            errs[BRANCH_KERNEL[run]].append(err)
    rom.WINDOWED_SOLVE_ITERS = "auto"
    launches = {"K1": runs["fused"][0][0], "K2": runs["matrices"][0][1],
                "K3": runs["v2"][0][2],
                "K1_richardson": runs["richardson"][0][0]}
    serving = {run: info for run, (_l, _o, info) in runs.items()}
    serving["policy"] = dict(rho=rho, solve_iters=decision)
    kernels["K1"] = dict(kernels.pop("fused"), **{
        f"richardson_{k}": v for k, v in kernels.pop("richardson").items()})
    return launches, kernels, serving


def serve_global(rom, label, batches, mods, power, kernel):
    """Drive one global branch (``engine="pallas"``) as
    :func:`serve_branch` drives a windowed one: one launch of ``kernel``
    per call and no other launch."""
    Bb = len(batches[0])
    launches, _rich, designs, outs, times = serve_calls(rom, batches, mods,
                                                        "pallas")
    calls = len(batches)
    want = [0, 0, 0, calls, 0] if kernel == "K4" else [0, 0, 0, 0, calls]
    # K4's and K5's runs launch their serving body only.
    want_designs = {k: (n, 0) for k, n in zip(KERNELS, want)}
    info = call_info(Bb, times)
    print(f"global serving, {label}: {calls} calls of {Bb} μ, median "
          f"{info['serve_ms_median']:.1f} ms per call (min "
          f"{info['serve_ms_min']:.1f}, max {info['serve_ms_max']:.1f}) = "
          f"{info['solves_per_s']:.1f} solves/s (prep + sweep + fetch, "
          f"synchronized) on {power}; launches K1-K5 {launches}, "
          f"(serving design, first design) {designs}")
    if launches != want or designs != want_designs:
        raise AssertionError(f"{label} launched {launches} ({designs}), "
                             f"expected {want} ({want_designs})")
    check_served(outs, Bb, rom.N)
    return launches, outs, info


def global_serving_phase(mods, dev, power, errs):
    """Global serving on the synthetic N=15 and N=20 cells: K4, K5 with
    the budget at 0, K5 by the budget; then each branch's last batch again
    with the kernel against its twin on the serving inputs, and where its
    time goes."""
    import romtime_tpu_torch.rom.engines.global_fused as engine
    import romtime_tpu_torch.rom.engines.windowed_fused as products
    from romtime_tpu_torch.rom.engines.policy import PrecomputePolicy

    synth = mods["synth"]
    batches = [synth.synthetic_mus(B, seed=11 + r)
               for r in range(GLOBAL_CALLS)]
    cells = {}
    for N in (15, 20):
        t0 = time.perf_counter()
        cells[N] = synth.synthetic_global_cell(N=N, seed=N, device=dev)
        print(f"global cell N={N} (nx=1000, nt={GLOBAL_NT}) built in "
              f"{time.perf_counter() - t0:.1f} s")
    runs, kernels = {}, {}
    for label, N, budget, kname in (
            ("K4 branch (N=15)", 15, None, "K4"),
            ("K5 branch, budget 0 (N=15)", 15, 0, "K5"),
            ("K5 branch (N=20)", 20, None, "K5")):
        rom = cells[N]
        rom.ONLINE_PRECOMPUTE_BUDGET = (
            PrecomputePolicy.ONLINE_PRECOMPUTE_BUDGET if budget is None
            else budget)
        branch = engine.global_branch(GLOBAL_NT, mods["k1"].pad_dim(N), B,
                                      rom.precompute_choice)
        if branch != ("matrices" if kname == "K4" else "thetas"):
            raise AssertionError(f"{label}: B={B} routes to {branch}")
        launches, outs, info = serve_global(rom, label, batches, mods, power,
                                            kname)
        print(f"  {pivot_line(rom)}")

        # The last batch again: prep, kernel and twin on its inputs.
        mus = batches[-1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prepped = rom.prep(mus, engine="pallas")
        torch.cuda.synchronize()
        info["prep_ms"] = (time.perf_counter() - t0) * 1e3
        tables = rom._global_serving_tables()
        gsv = rom.global_serving
        (THm, THk, THf, g, b0), kw = engine.window_inputs(rom.fom, gsv,
                                                          prepped)
        info["materialize_ms"] = 0.0
        if kname == "K4":
            # The engine's lane-major product, and the reference layout's
            # einsum it replaced.
            info["einsum_ms"], ops = cuda_ms(
                lambda: products.window_operators(tables, 0, THm, THk, THf,
                                                  0, GLOBAL_NT), GLOBAL_REPS)
            info["materialize_ms"], lops = cuda_ms(
                lambda: products.window_operators_lanes(
                    tables, 0, THm, THk, THf, 0, GLOBAL_NT), GLOBAL_REPS)
            gap = max(rel_gap(x, y) for x, y in
                      zip(lops, mods["rs"].lane_major(*ops)))
            print(f"  the K4 branch's tables: lane-major product "
                  f"{info['materialize_ms']:.3f} ms, the reference layout's "
                  f"einsum {info['einsum_ms']:.3f} ms; they differ by "
                  f"{gap:.3e} of their scale")
            del lops
            args = (*ops, g, tables["T0"][0], tables["VE"][0], b0)
            del ops
        else:
            args = (THm, THk, THf, g, tables["Bm"][0], tables["Bk"][0],
                    tables["Bf"][0], tables["T0"][0], tables["VE"][0], b0)
            kw.update(engine.live_rows(tables))
        bnd = GLOBAL_BOUND[kname]
        klabel = f"{kname} on the serving inputs of the {label} (B={B})"
        if kname == "K5":
            row, want = theta_designs(mods, kname, args, kw, GLOBAL_REPS,
                                      klabel, check_global)
        else:
            row, want, _l, _k = table_designs(mods, kname, args, kw,
                                              GLOBAL_REPS, klabel,
                                              check_global)
            del _l
        errs[kname].append(row.pop("max_abs_err"))
        errs[kname].append(served_vs(
            f"{label} served outputs vs the twin's sweep:", outs[-1],
            want[0], want[1], N, dev))
        ms, plain_ms = row["ms"], row["plain_ms"]
        bms, by = bnd(args, kw)
        info.update(kernel_ms=ms, bound_ms=bms, bound_by=by, **{
            k: v for k, v in row.items() if k != "ms"})
        print(f"  {kname} {ms:.3f} ms/sweep, twin {plain_ms:.1f} ms/sweep, "
              f"bound {bms:.4f} ms ({by})")
        rest = (info["serve_ms_median"] - info["prep_ms"]
                - info["materialize_ms"] - ms)
        print(f"  breakdown: prep {info['prep_ms']:.1f} ms, materializing "
              f"MN/KL/fN {info['materialize_ms']:.1f} ms, {kname} "
              f"{ms:.1f} ms, the rest (probe mean, fetch) "
              f"{rest:.1f} ms")
        runs[label] = (launches, outs, info)
        if label != "K5 branch, budget 0 (N=15)":
            kernels[kname] = dict(row, bound_ms=bms, bound_by=by,
                                  launches=launches[KERNELS.index(kname)])
        del args, want, prepped
        torch.cuda.empty_cache()
    cells[15].ONLINE_PRECOMPUTE_BUDGET = (
        PrecomputePolicy.ONLINE_PRECOMPUTE_BUDGET)

    # K5 against K4 on the same μ, at the reference's own limit.
    print("K5 branch (budget 0) vs the K4 branch on the same μ (N=15):")
    k4_out = runs["K4 branch (N=15)"][1][-1]
    k5_out = runs["K5 branch, budget 0 (N=15)"][1][-1]
    errs["K5"].append(max(
        check("probes (time mean)", torch.as_tensor(k5_out["probes"]),
              torch.as_tensor(k4_out["probes"]), rel=THETA_VS_TABLES_REL),
        check("uN_final", torch.as_tensor(k5_out["uN_final"]),
              torch.as_tensor(k4_out["uN_final"]), rel=THETA_VS_TABLES_REL)))
    serving = {label: info for label, (_l, _o, info) in runs.items()}
    return kernels, serving, cells[15], batches[0]


def autotune_phase(rom, mus, repo, power):
    """One measured precompute autotune; the record goes under build/."""
    path = repo / "build" / "autotune_smoke.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.exists():
        path.unlink()
    rec = rom.autotune_online_precompute(mus, n_rep=2, path=str(path))
    rom._set_precompute_override(None)
    print(f"autotune on the global N=15 cell at B={len(mus)} on {power}: "
          f"winner {rec['winner']} ({json.dumps(rec)})")
    return rec


def fleet_phase(mods, dev, power):
    """The flagship fleet at full width (phase 8 of the module doc)."""
    import romtime_tpu_torch.rom.engines.windowed_fused as engine
    from romtime_tpu_torch.conventions import Stage

    synth = mods["synth"]
    t0 = time.perf_counter()
    rom = synth.synthetic_fleet(device=dev)
    ml = rom.mulocal
    nt = int(rom.fom.domain[rom.fom.NT])
    print(f"fleet: {ml.n_cells} cells {ml.cell_wn} (nx={rom.fom.mesh.nx}, "
          f"nt={nt}), "
          f"Mach edges {np.round(ml.edges, 6).tolist()}, registered cells "
          f"{[c for c, w in enumerate(ml.cells) if w.dilation is not None]}"
          f", built in {time.perf_counter() - t0:.1f} s")
    batches = [synth.synthetic_mus(B, seed=21 + r)
               for r in range(FLEET_CALLS + 1)]
    cell_lists = [ml.cell_of([rom.compute_piston_mach_number(m)
                              for m in mus]) for mus in batches]
    cells = cell_lists[-1]
    occupancy = np.bincount(cells, minlength=ml.n_cells).tolist()
    print(f"fleet occupancy of the last batch: real μ per cell {occupancy}"
          f", each occupied cell's sub-batch padded to {B} by cycling")

    # The policy's solve for each cell's (W, N) group, and the branch.
    t0 = time.perf_counter()
    policy = []
    for c, win in enumerate(ml.cells):
        rom._set_serving_windows(win)
        iters = rom._windowed_solve_iters()
        branch = engine.stage2_branch(nt, mods["k1"].pad_dim(win.N), B,
                                      rom.precompute_choice)
        policy.append(dict(cell=c, shape=f"{win.n_windows}x{win.N}",
                           branch=branch, solve_iters=iters,
                           rho=win._auto_iters_rho_value))
        print(f"  cell {c} {win.n_windows}x{win.N}: branch {branch} at "
              f"B={B}, measured ρ = {win._auto_iters_rho_value:.6g}, group "
              f"solve {'LU' if iters is None else f'{iters} Richardson'}")
        if branch != "fused":
            raise AssertionError(f"cell {c} routes to {branch} at B={B}")
    rom._set_serving_windows(ml.cells[0])
    print(f"  policy over the fleet: {time.perf_counter() - t0:.1f} s on "
          f"the host (float64)")

    def routed(mus):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = rom.solve_batch_mulocal(mus, mode="probes")
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    occupied = sorted(set(cells.tolist()))
    for c in counters(mods):
        c.launches = c.serving_launches = c.first_design_launches = 0
    _out, cold = routed(batches[0])
    warm = []
    for mus in batches[1:]:
        out, seconds = routed(mus)
        warm.append(seconds)
    launches = [c.launches for c in counters(mods)]
    designs = design_counts(mods)
    want = [sum(len(set(cl.tolist())) for cl in cell_lists), 0, 0, 0, 0]
    info = dict(call_info(B, warm), cold_ms=cold * 1e3,
                cold_solves_per_s=B / cold, occupancy=occupancy,
                policy=policy, launches=launches)
    print(f"fleet serving: cold call {cold * 1e3:.1f} ms = {B / cold:.1f} "
          f"solves/s (each cell's tables built); warm calls median "
          f"{info['serve_ms_median']:.1f} ms (min {info['serve_ms_min']:.1f}"
          f", max {info['serve_ms_max']:.1f}) = {info['solves_per_s']:.1f} "
          f"solves/s (prep + sweep + fetch + merge, {len(occupied)} full-"
          f"batch sweeps a call, synchronized) on {power}; launches K1-K5 "
          f"{launches}, (serving design, first design) {designs}")
    if launches != want or designs["K1"] != (want[0], 0):
        raise AssertionError(f"the fleet launched {launches} ({designs}), "
                             f"expected {want}")
    check_fleet_rows(out, B, ml)

    # Per cell on the last batch: prep, sweep, and (a) routed ≡ direct.
    mus = batches[-1]
    per_cell, worst = [], 0.0
    for c in occupied:
        idx = np.nonzero(cells == c)[0]
        sub = [dict(mus[int(i)]) for i in idx]
        sub = (sub * -(-B // len(sub)))[:B]
        win = ml.cells[c]
        rom._set_serving_windows(win)
        torch.cuda.synchronize()
        t = time.perf_counter()
        prepped = rom.prep(sub)
        torch.cuda.synchronize()
        prep_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        engine.windowed_sweep(rom.fom, win, prepped, rom._windowed_tables(),
                              rom)
        torch.cuda.synchronize()
        sweep_ms = (time.perf_counter() - t) * 1e3
        del prepped
        direct = rom.solve_batch(sub, mode="probes")
        for k, v in direct.items():
            for j, i in enumerate(idx):
                row = np.asarray(out[k][int(i)])
                # A key the cell does not emit per row (t without a law)
                # was merged as the shared value.
                want_row = v[j] if len(v) == B else v
                if not np.array_equal(row, want_row):
                    raise AssertionError(f"fleet cell {c}: routed {k} row "
                                         f"{i} differs from the direct "
                                         f"solve")
                worst = max(worst, float(np.abs(row - want_row).max()))
        if c == occupied[0]:
            dev_out = rom.solve_batch(sub, Stage.ONLINE, "probes", None,
                                      False)
            for k, v in dev_out.items():
                moved = (v.movedim(-1, 0) if v.ndim >= 2 else v)
                if (v.device.type != rom.device.type
                        or not np.array_equal(moved.cpu().numpy(),
                                              direct[k])):
                    raise AssertionError(f"host=False {k} is not the "
                                         f"{rom.device.type} tensor of the "
                                         f"host copy")
            print(f"  (c) host=False on cell {c}: {sorted(dev_out)} are "
                  f"{rom.device.type} tensors "
                  f"{[tuple(v.shape) for v in dev_out.values()]}, equal to "
                  f"the host copy once moved")
            del dev_out
        per_cell.append(dict(cell=c, real=int(len(idx)), prep_ms=prep_ms,
                             sweep_ms=sweep_ms))
        print(f"  cell {c} {win.n_windows}x{win.N} ({len(idx)} real μ): "
              f"prep {prep_ms:.1f} ms, sweep {sweep_ms:.1f} ms on {power}")
    rom._set_serving_windows(ml.cells[0])
    print(f"  (a) routed ≡ direct on every occupied cell: max abs diff "
          f"{worst} (limit 0)")
    info.update(per_cell=per_cell, routed_vs_direct_max_abs=worst)

    # (b) served K1 against the float32 lanes engine at B=128.
    info["served_vs_lanes"] = served_vs_lanes(rom, ml, mus, cells, mods,
                                              power, "(b)")
    return info


def check_fleet_rows(out, Bb, ml):
    """Shapes and finiteness of a routed fleet call's outputs."""
    nt_probes = out["probes"]
    if nt_probes.shape[0] != Bb or nt_probes.shape[2] != 2:
        raise AssertionError(f"fleet probes {nt_probes.shape}")
    Ns = {w.N for w in ml.cells}
    for r in out["uN_final"]:
        if np.shape(r)[0] not in Ns:
            raise AssertionError(f"fleet uN_final row {np.shape(r)}")
    values = [out["probes"], out["dil"], out["dil_oor"]] + list(
        out["uN_final"])
    if not all(torch.isfinite(torch.as_tensor(v)).all() for v in values):
        raise AssertionError("non-finite fleet outputs")


def timed(dev, fn):
    """(fn(), seconds), a CUDA device synchronized on both sides."""
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def max_gap(got, want):
    """(max |got − want|, max |want|) of two tensors on any devices."""
    got, want = got.detach().cpu(), want.detach().cpu()
    return ((got - want).abs().max().item(),
            max(want.abs().max().item(), 1e-30))


def same_code(label, got, want, power):
    """A card run against the explicit CPU run of the same code: every
    shared output within CERT_F64_REL of its scale."""
    worst = 0.0
    for key in sorted(want):
        if key == "t":
            continue
        err, scale = max_gap(got[key], want[key])
        ok = err <= CERT_F64_REL * scale
        print(f"  {label} {key}: card vs CPU max abs err {err:.3e} (scale "
              f"{scale:.3e}, limit {CERT_F64_REL * scale:.3e}) on {power} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label} {key}: card and CPU disagree")
        worst = max(worst, err / scale)
    return worst


def certification_phase(mods, dev, power):
    """Phase 9 of the module doc: the S-ROM certification path at full
    width, each part with its own line and time. The CPU runs of (b), (c)
    and (e) are explicit comparison runs (``device="cpu"``); nothing in
    the phase falls back or is caught."""
    from romtime_tpu_torch.conventions import Errors
    from romtime_tpu_torch.dtypes import compute_dtype_scope
    from romtime_tpu_torch.rom.engines import global_lanes, windowed_lanes
    from romtime_tpu_torch.rom.hrom import HyperReducedPiston

    synth = mods["synth"]
    nt = CERT_GRID["nt"]
    info = {"card": power}
    est, t_build = timed(dev, lambda: synth.synthetic_estimator(
        device=dev, **CERT_GRID))
    est_cpu = synth.synthetic_estimator(device="cpu", **CERT_GRID)
    print(f"certification: the synthetic estimator pair (ROM N={est.rom.N}, "
          f"S-ROM N={est.srom.N}, nx={CERT_GRID['nx']}, nt={nt}) built in "
          f"{t_build:.1f} s")
    for c in counters(mods):
        c.launches = c.serving_launches = c.first_design_launches = 0

    # (a) The global lanes engine in float32 at the serving batch, against
    # the served K4 (N=15) and K5 (N=20) on the same μ.
    mus = synth.synthetic_mus(CERT_B, seed=31)
    info["lanes_f32"] = []
    for rom, kname, branch in ((est.rom, "K4", "matrices"),
                               (est.srom, "K5", "thetas")):
        engine = rom._resolve_engine("reduced", CERT_B)
        got_branch = global_lanes.lanes_branch(nt, rom.N, CERT_B,
                                               torch.float32,
                                               rom.precompute_choice)
        nbytes = global_lanes.table_bytes(nt, rom.N, CERT_B, torch.float32)
        print(f"  (a) N={rom.N}, B={CERT_B}, float32: solve_batch(mus, "
              f"mode='reduced') resolves to {engine!r}, precompute branch "
              f"{got_branch} ({nbytes / 2**30:.2f} GiB of tables)")
        if engine != "lanes" or got_branch != branch:
            raise AssertionError(f"N={rom.N}: resolved {engine}/"
                                 f"{got_branch}, expected lanes/{branch}")
        lanes, seconds = timed(dev, lambda: rom.solve_batch(
            mus, mode="reduced", host=False))
        served, served_s = timed(dev, lambda: rom.solve_batch(
            mus, mode="probes", host=False))
        perr, pscale = max_gap(lanes["probes"], served["probes"])
        uerr, uscale = max_gap(lanes["uN"][-1], served["uN_final"])
        uscale = max(lanes["uN"][-1].abs().max().item(), 1.0)
        ok = (perr <= CERT_PROBES_REL * pscale and uerr <= CERT_UN_REL * uscale
              and bool(torch.isfinite(lanes["uN"]).all()))
        print(f"  (a) N={rom.N}: lanes engine {seconds:.2f} s a call = "
              f"{CERT_B / seconds:.1f} solves/s; served {kname} "
              f"{served_s * 1e3:.1f} ms a call; lanes vs {kname} probes max "
              f"abs err {perr:.3e} (limit {CERT_PROBES_REL * pscale:.3e}), "
              f"uN_final {uerr:.3e} (limit {CERT_UN_REL * uscale:.3e}) on "
              f"{power} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"N={rom.N}: the lanes engine disagrees "
                                 f"with {kname}")
        info["lanes_f32"].append(dict(
            N=rom.N, B=CERT_B, branch=got_branch, table_bytes=nbytes,
            lanes_s=seconds, solves_per_s=CERT_B / seconds,
            served_kernel=kname, served_ms=served_s * 1e3, probes_err=perr,
            probes_limit=CERT_PROBES_REL * pscale, uN_err=uerr,
            uN_limit=CERT_UN_REL * uscale))
        del lanes, served
        torch.cuda.empty_cache()

    # (b) and (c): estimate_batch in float64 at the certification batch,
    # on the card and in an explicit CPU run; (b) holds the two runs'
    # lanes sweeps (the global lanes engine in float64), (c) the estimator.
    cert = synth.certification_mus()
    with compute_dtype_scope(torch.float64):
        out, est_s = timed(dev, lambda: est.estimate_batch(cert))
        ref, cpu_s = timed("cpu", lambda: est_cpu.estimate_batch(cert))
    print(f"  (b) estimate_batch, B={len(cert)}, float64: the card "
          f"{est_s:.2f} s a call (two global lanes sweeps, resolved to "
          f"{est.rom._resolve_engine('reduced', len(cert))!r}), the CPU run "
          f"{cpu_s:.2f} s")
    worst = max(same_code(f"{name} N={o['uN'].shape[1]}", out[name], ref[name],
                          power) for name, o in (("rom", out["rom"]),
                                                 ("srom", out["srom"])))
    V_srom = np.asarray(est.srom.global_serving.basis)
    formula_gap, bound_slack, avg = estimator_contract(out, ref, V_srom, nt)
    print(f"  (c) estimator (16, {nt}) finite and ≥ 0, time averages "
          f"{avg[0]:.4e}..{avg[1]:.4e}; equals "
          f"compute_rom_difference on its trajectories (largest relative "
          f"gap {formula_gap:.2e}, limit 1e-10); card vs CPU within the "
          f"triangle bound of (b)'s gaps (smallest slack {bound_slack:.3e})"
          f" on {power} ok")
    info["global_estimator"] = dict(
        B=len(cert), card_s=est_s, cpu_s=cpu_s, trajectory_rel_gap=worst,
        formula_rel_gap=formula_gap, bound_slack=bound_slack,
        average_min=avg[0], average_max=avg[1])
    del out, ref

    # (d) The fleet estimator, float64, on the nested synthetic fleet.
    fleet, t_build = timed(dev, lambda: synth.synthetic_fleet(
        device=dev, srom_extra=SROM_EXTRA, **CERT_GRID))
    ml = fleet.mulocal
    hp = HyperReducedPiston.from_serving(fleet)
    # Every cell occupied (the box's draws leave the top Mach cell nearly
    # empty): μ taken from a seeded draw cell by cell, in turn.
    draw = synth.synthetic_mus(4096, seed=41)
    pool = ml.cell_of([fleet.compute_piston_mach_number(m) for m in draw])
    queues = [list(np.nonzero(pool == c)[0]) for c in range(ml.n_cells)]
    picks = []
    while len(picks) < CERT_SMALL_B:
        for q in queues:
            if q and len(picks) < CERT_SMALL_B:
                picks.append(int(q.pop(0)))
    fmus = [draw[i] for i in picks]
    cells = ml.cell_of([fleet.compute_piston_mach_number(m) for m in fmus])
    print(f"  (d) the nested fleet {ml.cell_wn} over S-ROM cells "
          f"{[(w.n_windows, w.N) for w in ml.cells_srom]} built in "
          f"{t_build:.1f} s; μ per cell "
          f"{np.bincount(cells, minlength=ml.n_cells).tolist()}")
    served_before = fleet.solve_batch_mulocal(fmus, mode="probes")
    real = hp.estimate_batch
    per_cell = []

    def cell_timed(sub, step, engine):
        win = fleet.windows
        got, sec = timed(dev, lambda: real(sub, step=step, engine=engine))
        per_cell.append(dict(cell=f"{win.n_windows}x{win.N}", seconds=sec))
        return got

    hp.estimate_batch = cell_timed
    try:
        with compute_dtype_scope(torch.float64):
            fest, fest_s = timed(dev, lambda: hp.estimate_batch_mulocal(fmus))
            perm = np.random.default_rng(5).permutation(CERT_SMALL_B)
            again = hp.estimate_batch_mulocal([fmus[i] for i in perm])
    finally:
        del hp.estimate_batch
    served_after = fleet.solve_batch_mulocal(fmus, mode="probes")
    fe, favg = fest[Errors.ESTIMATOR], fest[Errors.AVERAGE_ESTIMATOR]
    if (fe.shape != (CERT_SMALL_B, nt) or favg.shape != (CERT_SMALL_B,)
            or not np.isfinite(favg).all() or (favg <= 0).any()):
        raise AssertionError(f"fleet estimator {fe.shape}, averages "
                             f"{favg.shape}: not finite and > 0")
    if not (np.array_equal(again[Errors.ESTIMATOR], fe[perm])
            and np.array_equal(again[Errors.AVERAGE_ESTIMATOR], favg[perm])):
        raise AssertionError("a permuted batch did not return the permuted "
                             "rows bit for bit")
    for k, v in served_before.items():
        if not all(np.array_equal(a, b) for a, b in
                   zip(v, served_after[k])):
            raise AssertionError(f"served {k} changed across the estimator")
    if fleet.windows is not ml.cells[0] or hp.windows_srom is not None:
        raise AssertionError("the estimator left the fleet's windows swapped")
    # Each μ's estimator row against the coefficient-difference norm of
    # its own merged trajectories: the rows merge consistently. (The
    # synthetic windows carry only their bases' end rows, not orthonormal
    # bases, so compute_rom_difference's reconstruction form does not
    # apply to them.)
    fformula = 0.0
    for b, c in enumerate(cells):
        uN_b, uNs_b = fest["rom"][b], fest["srom"][b]
        diff = uNs_b.copy()
        diff[:, :uN_b.shape[1]] -= uN_b
        same = (np.linalg.norm(diff, axis=1)
                / np.sqrt(np.asarray(ml.cells_srom[int(c)].Vs).shape[1]))
        if not np.allclose(fe[b], same, rtol=1e-12, atol=0.0):
            raise AssertionError(f"fleet μ {b}: the estimator row is not "
                                 f"its merged trajectories' norm")
        fformula = max(fformula, float(np.max(
            np.abs(fe[b] - same) / np.maximum(np.abs(same), 1e-300))))
    print(f"  (d) estimate_batch_mulocal, B={CERT_SMALL_B}, float64: "
          f"{fest_s:.2f} s a call; per cell "
          + ", ".join(f"{r['cell']} {r['seconds']:.2f} s"
                      for r in per_cell[:len(per_cell) // 2])
          + f"; averages {float(favg.min()):.4e}..{float(favg.max()):.4e}; "
          f"each row the norm of its μ's merged trajectories (largest "
          f"relative gap {fformula:.2e}, limit 1e-12); "
          f"the permuted batch's rows bit for bit; the served fleet equal "
          f"before and after, bit for bit, on {power} ok")
    info["fleet_estimator"] = dict(
        B=CERT_SMALL_B, seconds=fest_s, formula_rel_gap=fformula,
        per_cell=per_cell[:len(per_cell) // 2],
        average_min=float(favg.min()), average_max=float(favg.max()))
    del fleet, hp

    # (e) The chained variant on unequal widths, and on equal widths
    # against the equal-width engine.
    cmus = synth.synthetic_mus(CERT_SMALL_B, seed=51)
    cells7 = {d: synth.synthetic_cell(seed=7, n_windows=CHAINED_W, N=32,
                                      device=d, **CERT_GRID)
              for d in (dev, "cpu")}
    widths = sorted(set(np.diff(cells7[dev].windows.bounds).tolist()))
    with compute_dtype_scope(torch.float64):
        runs = {d: timed(d, lambda r=r: r.solve_batch(
            cmus, mode="reduced", engine="windowed", host=False))
            for d, r in cells7.items()}
    print(f"  (e) chained, W={CHAINED_W} (widths {widths}), N=32, "
          f"B={CERT_SMALL_B}, float64: the card {runs[dev][1]:.2f} s, the "
          f"CPU run {runs['cpu'][1]:.2f} s")
    chained_gap = same_code("chained", runs[dev][0], runs["cpu"][0], power)
    cell = synth.synthetic_cell(device=dev, **CERT_GRID)
    with compute_dtype_scope(torch.float64):
        equal, equal_s = timed(dev, lambda: cell.solve_batch(
            cmus, mode="reduced", engine="windowed", host=False))
        direct, direct_s = timed(dev, lambda: (
            windowed_lanes.online_sweep_windowed_chained(
                cell.fom, cell.windows, cell._theta_sources(),
                cell._lanes_tables("reduced"), cell._mu_batch(cmus),
                "reduced")))
    eq_gap = 0.0
    for key in ("uN", "probes"):
        err, scale = max_gap(direct[key], equal[key])
        eq_gap = max(eq_gap, err / scale)
        if err > CERT_F64_REL * scale:
            raise AssertionError(f"the chained variant on equal widths "
                                 f"disagrees on {key}")
    print(f"  (e) chained on the equal-width 50x32 cell vs the equal-width "
          f"engine: largest relative gap {eq_gap:.3e} (limit "
          f"{CERT_F64_REL:.0e}); {direct_s:.2f} s and {equal_s:.2f} s on "
          f"{power} ok")
    info["chained"] = dict(widths=widths, card_s=runs[dev][1],
                           cpu_s=runs["cpu"][1], rel_gap=chained_gap,
                           equal_width_rel_gap=eq_gap, direct_s=direct_s,
                           equal_s=equal_s)
    launches = [c.launches for c in counters(mods)]
    info["launches"] = launches
    print(f"certification launches K1-K5 {launches} (K4 and K5 by (a)'s "
          f"yardsticks, the served fleet's kernels by (d))")
    if launches[3] != 1 or launches[4] != 1:
        raise AssertionError(f"phase 9 launched {launches}: K4 and K5 "
                             f"once each expected")
    return info


def per_mu_rel(got, want):
    """Relative L2 gap per μ of two (B, ...) arrays."""
    got = np.asarray(got, np.float64).reshape(len(want), -1)
    want = np.asarray(want, np.float64).reshape(len(want), -1)
    return (np.linalg.norm(got - want, axis=1)
            / np.maximum(np.linalg.norm(want, axis=1), 1e-300))


def fom_mus():
    """FOM_B μ dicts from the synthetic cells' μ box by the port's
    sampler (sorted keys, one seeded RandomState stream)."""
    from romtime_tpu_torch.parameters import (
        ParameterSampler,
        get_uniform_dist,
    )
    from romtime_tpu_torch.testing.synthetic import MU_BOX

    grid = {k: get_uniform_dist(lo, hi) for k, (lo, hi) in MU_BOX.items()}
    return [{k: float(v) for k, v in mu.items()}
            for mu in ParameterSampler(grid, FOM_B, random_state=FOM_SEED)]


def check_fom_outputs(label, out, B, nnz, dd):
    """The reference's keys and shapes, (B, nt, …), all finite."""
    nt, nh = FOM_GRID["nt"], FOM_GRID["nx"] + 1
    keys = set(FOM_KEYS) | ({"uh_lo"} if dd else set())
    shapes = {"uh": (B, nt, nh), "uc": (B, nt, nh), "x": (B, nt, nh),
              "uh_lo": (B, nt, nh), "t": (B, nt), "probes": (B, nt, 3),
              "nonlinear_data": (B, nt, nnz)}
    if set(out) != keys:
        raise AssertionError(f"{label}: keys {sorted(out)}")
    for k, v in out.items():
        if v.shape != shapes[k] or not np.isfinite(v).all():
            raise AssertionError(f"{label} {k}: {v.shape}, finite "
                                 f"{bool(np.isfinite(v).all())}")


def fom_phase(dev, power):
    """Phase 10 of the module doc: the piston FOM at the flagship width,
    each part with its own line and time. The CPU run of (b) is an
    explicit comparison run (``device="cpu"``); nothing falls back."""
    from romtime_tpu_torch.convert import piston_fom
    from romtime_tpu_torch.dtypes import compute_dtype_scope
    from romtime_tpu_torch.parallel import solve_fom_batch

    nt = FOM_GRID["nt"]
    fom, t_build = timed(dev, lambda: piston_fom(**FOM_GRID, device=dev))
    nnz = len(fom._nonlinear_topology[0])
    mus = fom_mus()
    check = mus[:FOM_CHECK_B]
    print(f"FOM: the piston FOM (nx={FOM_GRID['nx']}, nt={nt}, P1, BDF-2, "
          f"rest; {nnz} nonlinear entries) set up in {t_build:.2f} s; "
          f"{FOM_B} μ from the sampler (seed {FOM_SEED})")
    info = {"card": power, "grid": dict(FOM_GRID, degree=1, bdf="2",
                                        which="rest"),
            "B": FOM_B, "seed": FOM_SEED, "nnz": nnz, "launches": None}

    # (a) float32 at the full batch, plain and dd; the first 4 μ kept.
    kept = {}
    for dd in (False, True):
        label = "dd" if dd else "plain"
        fom.dd_sweep = dd
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out, sec = timed(dev, lambda: solve_fom_batch(fom, mus))
        peak = torch.cuda.max_memory_allocated()
        check_fom_outputs(f"(a) {label}", out, FOM_B, nnz, dd)
        kept[dd] = {k: v[:FOM_CHECK_B].copy() for k, v in out.items()}
        del out
        info[f"f32_{label}"] = dict(
            seconds=sec, ms_per_step=sec / nt * 1e3,
            mu_steps_per_s=FOM_B * nt / sec, peak_bytes=peak)
        print(f"  (a) solve_fom_batch float32 {label}, B={FOM_B}: "
              f"{sec:.2f} s a sweep, {sec / nt * 1e3:.3f} ms a step, "
              f"{FOM_B * nt / sec:.1f} μ·steps/s, peak device memory "
              f"{peak / 2**30:.2f} GiB; keys and shapes as the reference's, "
              f"finite, on {power} ok")

    # (b) float64, the first 4 μ, the card against the CPU.
    fom.dd_sweep = False
    fom_cpu = piston_fom(**FOM_GRID, device="cpu")
    with compute_dtype_scope(torch.float64):
        card64, card_s = timed(dev, lambda: solve_fom_batch(fom, check))
        cpu64, cpu_s = timed("cpu", lambda: solve_fom_batch(fom_cpu, check))
    check_fom_outputs("(b) card", card64, FOM_CHECK_B, nnz, False)
    gaps = {}
    for key in ("uh", "uc", "probes", "nonlinear_data"):
        gaps[key] = float(per_mu_rel(card64[key], cpu64[key]).max())
        if not gaps[key] <= FOM_F64_REL:
            raise AssertionError(f"(b) {key}: card vs CPU {gaps[key]:.3e}")
    print(f"  (b) float64, B={FOM_CHECK_B}: the card {card_s:.2f} s "
          f"({card_s / nt * 1e3:.3f} ms a step), the CPU run {cpu_s:.2f} s; "
          f"card vs CPU largest relative gap per μ "
          + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items())
          + f" (limit {FOM_F64_REL:.0e}) on {power} ok")
    info["f64_card_vs_cpu"] = dict(B=FOM_CHECK_B, card_s=card_s,
                                   cpu_s=cpu_s, rel_gaps=gaps)

    # (c) the float32 sweeps of (a) against (b)'s float64 card sweep.
    plain = float(per_mu_rel(kept[False]["uh"], card64["uh"]).max())
    dd_traj = kept[True]["uh"].astype(np.float64) + kept[True]["uh_lo"]
    dd = float(per_mu_rel(dd_traj, card64["uh"]).max())
    hi = float(np.abs(kept[True]["uh"]).max())
    lo = float(np.abs(kept[True]["uh_lo"]).max())
    ok = (dd < FOM_DD_DRIFT and dd < FOM_DD_VS_PLAIN * plain
          and 0.0 < lo < FOM_LO_REL * hi)
    print(f"  (c) float32 against float64 on {FOM_CHECK_B} μ: plain drift "
          f"{plain:.3e}, dd drift {dd:.3e} (limits {FOM_DD_DRIFT:.0e} and "
          f"{FOM_DD_VS_PLAIN:.0f}× plain), low words max {lo:.3e} of hi "
          f"{hi:.3e} (limit {FOM_LO_REL:.0e}·hi) on {power} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("(c) the float32 sweeps miss the dd limits")
    info["f32_vs_f64"] = dict(plain_drift=plain, dd_drift=dd, lo_max=lo,
                              hi_max=hi)

    # (d) the piston probe on the Dirichlet value, float64.
    probe_err = 0.0
    for b, mu in enumerate(check):
        bL = (-mu["delta"] * (mu["omega"] / mu["a0"])
              * np.sin(mu["omega"] * card64["t"][b]))
        probe_err = max(probe_err,
                        float(np.abs(card64["probes"][b, :, 2] - bL).max()))
    print(f"  (d) piston probe against bL, float64: max abs err "
          f"{probe_err:.3e} (limit {FOM_PROBE_ATOL:.0e}) on {power} "
          f"{'ok' if probe_err <= FOM_PROBE_ATOL else 'FAIL'}")
    if not probe_err <= FOM_PROBE_ATOL:
        raise AssertionError("(d) the piston probe misses bL")
    info["probe_vs_bL"] = probe_err

    # (e) the serial solve() against its row of (b).
    fom.update_parametrization(check[0])
    with compute_dtype_scope(torch.float64):
        _, serial_s = timed(dev, fom.solve)
    sols = fom.solutions
    pr = np.stack([np.asarray(v) for v in fom.probes.values()], axis=1)
    serial = {
        "uh": float(per_mu_rel(sols.snapshots.T[None], card64["uh"][:1])[0]),
        "uc": float(per_mu_rel(sols.fom.T[None], card64["uc"][:1])[0]),
        "probes": float(per_mu_rel(pr[None], card64["probes"][:1])[0]),
        "nonlinear_data": float(per_mu_rel(
            np.asarray(fom.nonlinear_snapshots)[None],
            card64["nonlinear_data"][:1])[0])}
    ok = all(v <= FOM_SERIAL_REL for v in serial.values())
    print(f"  (e) fom.solve() on the card, float64: {serial_s:.2f} s; "
          f"against its row of (b): "
          + ", ".join(f"{k} {v:.2e}" for k, v in serial.items())
          + f" (limit {FOM_SERIAL_REL:.0e}) on {power} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("(e) solve() disagrees with its batch row")
    info["serial"] = dict(seconds=serial_s, rel_gaps=serial)
    return info


def estimator_contract(out, ref, V_srom, nt):
    """tests/test_hrom.py:442-520's contract between the card's estimate
    ``out`` and an explicit CPU run ``ref`` of the same pair: the
    estimator finite, ≥ 0 and (B, nt); equal to compute_rom_difference
    on its own trajectories (rtol 1e-10, atol 1e-17); within the triangle
    bound of the two runs' trajectory gaps. Returns (the largest relative
    formula gap, the smallest bound slack, the time averages' range)."""
    from romtime_tpu_torch.conventions import Errors
    from romtime_tpu_torch.utils import compute_rom_difference

    e, e_cpu = out[Errors.ESTIMATOR], ref[Errors.ESTIMATOR]
    avg = out[Errors.AVERAGE_ESTIMATOR]
    B = e_cpu.shape[0]
    if (e.shape != (B, nt) or not np.isfinite(e).all()
            or (e < 0).any() or not np.isfinite(avg).all()):
        raise AssertionError(f"estimator {e.shape}: not finite and ≥ 0")
    uN = out["rom"]["uN"].movedim(-1, 0).cpu().numpy()
    uNs = out["srom"]["uN"].movedim(-1, 0).cpu().numpy()
    uN_c = ref["rom"]["uN"].movedim(-1, 0).numpy()
    uNs_c = ref["srom"]["uN"].movedim(-1, 0).numpy()
    formula_gap, bound_slack = 0.0, np.inf
    for b in range(B):
        same = np.array([compute_rom_difference(uN[b, i], uNs[b, i], V_srom)
                         for i in range(nt)])
        if not np.allclose(e[b], same, rtol=1e-10, atol=1e-17):
            raise AssertionError(f"μ {b}: the estimator is not the "
                                 f"reconstruction-norm formula")
        formula_gap = max(formula_gap, float(np.max(
            np.abs(e[b] - same) / np.maximum(np.abs(same), 1e-300))))
        noise = (np.linalg.norm(uN[b] - uN_c[b], axis=1)
                 + np.linalg.norm(uNs[b] - uNs_c[b], axis=1)) / np.sqrt(
                     V_srom.shape[0])
        gap = np.abs(e[b] - e_cpu[b])
        limit = noise + 1e-12 * e_cpu[b] + 1e-16
        if not np.all(gap <= limit):
            raise AssertionError(f"μ {b}: card and CPU estimators differ "
                                 f"beyond the triangle bound")
        bound_slack = min(bound_slack, float(np.min(limit - gap)))
    return formula_gap, bound_slack, (float(avg.min()), float(avg.max()))


def build_pipeline(dev, grid, workdir, profile="throughput_profile"):
    """bench.py's offline sequence (bench.py:209-262) with the port on
    ``dev`` in ``workdir`` for ``problems.<profile>``: returns the
    pipeline, each stage's seconds and the calls of the snapshot assembly
    (one per μ and trained operator, the tree walk's times its trailing
    batch)."""
    from romtime_tpu_torch import problems
    from romtime_tpu_torch.deim import DiscreteEmpiricalInterpolation
    from romtime_tpu_torch.rom.hrom import HyperReducedPiston

    calls = [0]
    real = DiscreteEmpiricalInterpolation.assemble_snapshots_batch

    def counted(self, mu, ts):
        calls[0] += 1
        return real(self, mu, ts)

    cwd = os.getcwd()
    os.chdir(workdir)
    DiscreteEmpiricalInterpolation.assemble_snapshots_batch = counted
    try:
        hrom = HyperReducedPiston(**getattr(problems, profile)(device=dev,
                                                              **grid))
        _, setup_s = timed(dev, lambda: (hrom.setup(),
                                         hrom.setup_hyperreduction()))
        timed(dev, lambda: hrom.run_offline_rom(device_sweep=True))
        timed(dev, lambda: hrom.run_offline_hyperreduction(
            mu_space=hrom.mu_space["offline"], evaluate=False))
        hrom.project_reductors()
        _, tri_s = timed(dev, lambda: (hrom.rom.global_serving,
                                       hrom.srom.global_serving))
        _, dump_s = timed(dev, lambda: (hrom.dump_mu_space(),
                                        hrom.dump_reduced_basis(),
                                        hrom.dump_offline_snapshots()))
    finally:
        DiscreteEmpiricalInterpolation.assemble_snapshots_batch = real
        os.chdir(cwd)
    seconds = dict(setup=setup_s, **hrom.build_seconds,
                   trilinear_tables=tri_s, dumps=dump_s)
    return hrom, seconds, calls[0]


def dof_sets(hrom):
    """operator → the ROM reductor's dofs."""
    return {name: list(getattr(hrom.rom, attr).dofs) for name, attr in (
        ("mass", "mdeim_Mh"), ("stiffness", "mdeim_Ah"),
        ("rhs", "deim_rhs"), ("convection", "mdeim_Ch"),
        ("nonlinear_lifting", "mdeim_Nh_hat"), ("trilinear", "mdeim_Nh"))}


def offline_build_phase(mods, dev, power):
    """Phase 11 of the module doc: the port builds bench.py's throughput
    profile on the card in float64, serves it through K4 and K5 and
    certifies it; then the same build on the CPU. The CPU build and runs
    are explicit comparison runs (``device="cpu"``); nothing falls back."""
    import tempfile

    from romtime_tpu_torch.convert import (
        estimator_from_arrays,
        estimator_to_arrays,
    )
    from romtime_tpu_torch.dtypes import compute_dtype_scope
    from romtime_tpu_torch.rom.engines.global_fused import global_branch

    synth = mods["synth"]
    nt = BUILD_GRID["nt"]
    info = {"card": power, "grid": dict(BUILD_GRID)}

    # (a) The build, on the card, in a temporary directory.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as workdir:
        hrom, seconds, calls = build_pipeline(dev, BUILD_GRID, workdir)
        dumped = sorted(os.listdir(workdir))
    peak = torch.cuda.max_memory_allocated()
    rom, srom = hrom.rom, hrom.srom
    dofs = dof_sets(hrom)
    print(f"offline build: bench.py's throughput profile (nx="
          f"{BUILD_GRID['nx']}, nt={nt}, P1, BDF-2, float64) on the card: "
          f"ROM N={rom.N}, S-ROM N={srom.N}, dofs "
          + ", ".join(f"{k} {len(v)}" for k, v in dofs.items())
          + "; offline μ at Mach "
          + ", ".join(f"{m['piston_mach']:.4f}"
                      for m in hrom.mu_space["offline"]))
    print("  (a) seconds: " + ", ".join(f"{k} {v:.2f}"
                                         for k, v in seconds.items())
          + f"; {calls} snapshot-assembly calls; peak device memory "
          f"{peak / 2**30:.3f} GiB; dumped {len(dumped)} files on {power}")
    if rom.N != 15 or srom.N != 20:
        raise AssertionError(f"built N={rom.N}/{srom.N}, expected 15/20")
    info.update(seconds=seconds, snapshot_calls=calls, peak_bytes=peak,
                N=rom.N, N_srom=srom.N, dofs={k: len(v)
                                              for k, v in dofs.items()},
                dumped=dumped)

    # (b) Serving B=2048 through K4 (ROM) and K5 (S-ROM), every counter
    # set to 0 just before and read just after; then K5 on the ROM.
    mus = synth.synthetic_mus(BUILD_B, seed=41)
    for c in counters(mods):
        c.launches = c.serving_launches = c.first_design_launches = 0
    served, info["serve"] = {}, []
    for label, r in (("ROM", rom), ("S-ROM", srom)):
        branch = global_branch(nt, mods["k1"].pad_dim(r.N), BUILD_B,
                               r.precompute_choice)
        engine = r._resolve_engine("probes", BUILD_B)
        _, cold = timed(dev, lambda: r.solve_batch(mus, mode="probes"))
        served[label], warm = timed(dev, lambda: r.solve_batch(
            mus, mode="probes"))
        print(f"  (b) {label} N={r.N}, B={BUILD_B}: engine {engine!r}, "
              f"branch {branch}; cold {cold:.3f} s, warm {warm:.3f} s = "
              f"{BUILD_B / warm:.1f} solves/s on {power}")
        info["serve"].append(dict(N=r.N, engine=engine, branch=branch,
                                  cold_s=cold, warm_s=warm,
                                  solves_per_s=BUILD_B / warm))
    launches = [c.launches for c in counters(mods)]
    print(f"  (b) launches K1-K5 over the two ROMs' calls: {launches}")
    if not (launches[3] > 0 and launches[4] > 0) or any(launches[:3]):
        raise AssertionError(f"the built ROMs did not serve through K4 and "
                             f"K5 alone: {launches}")
    info["launches"] = launches
    rom.ONLINE_PRECOMPUTE_BUDGET = 0
    try:
        k5 = rom.solve_batch(mus, mode="probes")
    finally:
        del rom.ONLINE_PRECOMPUTE_BUDGET
    err = max_gap(torch.as_tensor(k5["probes"]),
                  torch.as_tensor(served["ROM"]["probes"]))
    ok = err[0] <= THETA_VS_TABLES_REL * err[1]
    print(f"  (b) K5 (budget 0) vs K4 on the ROM, same μ: probes max abs "
          f"err {err[0]:.3e} (limit {THETA_VS_TABLES_REL * err[1]:.3e}) on "
          f"{power} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("K5 disagrees with K4 on the built ROM")
    info["k5_vs_k4"] = err[0] / err[1]
    small = mus[:BUILD_CHECK_B]
    info["served_vs_lanes"] = []
    for label, r in (("ROM", rom), ("S-ROM", srom)):
        with compute_dtype_scope(torch.float64):
            lanes = r.solve_batch(small, mode="probes", engine="lanes")
        got = {k: v[:BUILD_CHECK_B] for k, v in served[label].items()}
        perr = float(np.abs(got["probes"] - lanes["probes"]).max())
        pscale = float(np.abs(lanes["probes"]).max())
        uerr = float(np.abs(got["uN_final"] - lanes["uN_final"]).max())
        uscale = max(float(np.abs(lanes["uN_final"]).max()), 1.0)
        ok = (perr <= CERT_PROBES_REL * pscale
              and uerr <= CERT_UN_REL * uscale)
        print(f"  (b) served {label} vs the float64 lanes engine, B="
              f"{BUILD_CHECK_B}: probes {perr:.3e} (limit "
              f"{CERT_PROBES_REL * pscale:.3e}), uN_final {uerr:.3e} (limit "
              f"{CERT_UN_REL * uscale:.3e}) on {power} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"served {label} misses the lanes engine")
        info["served_vs_lanes"].append(dict(N=r.N, probes_err=perr,
                                            probes_scale=pscale,
                                            uN_err=uerr))

    # (c) Certification in float64 at B=16, the card against the same
    # pair carried to the CPU.
    cert = synth.certification_mus()
    est_cpu = estimator_from_arrays(estimator_to_arrays(hrom), device="cpu")
    with compute_dtype_scope(torch.float64):
        out, est_s = timed(dev, lambda: hrom.estimate_batch(cert))
        ref, cpu_s = timed("cpu", lambda: est_cpu.estimate_batch(cert))
    worst = max(same_code(f"(c) {name}", out[name], ref[name], power)
                for name in ("rom", "srom"))
    formula, slack, avg = estimator_contract(
        out, ref, np.asarray(srom.basis), nt)
    print(f"  (c) estimate_batch, B={len(cert)}, float64: the card "
          f"{est_s:.2f} s, the CPU run {cpu_s:.2f} s; estimator finite, "
          f"≥ 0, time averages {avg[0]:.4e}..{avg[1]:.4e}; the formula "
          f"within {formula:.2e} (limit 1e-10); card vs CPU within the "
          f"triangle bound (smallest slack {slack:.3e}) on {power} ok")
    info["estimator"] = dict(B=len(cert), card_s=est_s, cpu_s=cpu_s,
                             trajectory_rel_gap=worst, formula_rel_gap=formula,
                             bound_slack=slack, average=avg)
    del out, ref, est_cpu

    # (d) The same build on the CPU.
    with tempfile.TemporaryDirectory() as workdir:
        (cpu, cpu_seconds, _c), cpu_s = timed(
            "cpu", lambda: build_pipeline("cpu", BUILD_CPU_GRID, workdir))
    same_mu = cpu.mu_space["offline"] == hrom.mu_space["offline"]
    cpu_dofs = dof_sets(cpu)
    order = {k: cpu_dofs[k] == v for k, v in dofs.items()}
    sets = all(sorted(cpu_dofs[k]) == sorted(v) for k, v in dofs.items())
    with compute_dtype_scope(torch.float64):
        card_p = rom.solve_batch(small, mode="probes", engine="lanes")
        cpu_p = cpu.rom.solve_batch(small, mode="probes", engine="lanes")
    gap = float(np.abs(card_p["probes"] - cpu_p["probes"]).max())
    scale = float(np.abs(cpu_p["probes"]).max())
    ok = same_mu and sets and gap <= CERT_F64_REL * scale
    print(f"  (d) the CPU build ({cpu_s:.1f} s: " + ", ".join(
        f"{k} {v:.2f}" for k, v in cpu_seconds.items())
          + f"): offline μ identical {same_mu}; dofs identical as sets "
          f"{sets}, in order " + ", ".join(f"{k} {v}"
                                            for k, v in order.items())
          + f"; float64 lanes probes card vs CPU build {gap:.3e} (limit "
          f"{CERT_F64_REL * scale:.3e}) on {power} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the card and CPU builds disagree")
    info["cpu_build"] = dict(grid=dict(BUILD_CPU_GRID), seconds=cpu_s,
                             stages=cpu_seconds, same_mu=same_mu,
                             dofs_same_sets=sets, dofs_same_order=order,
                             probes_gap=gap, probes_scale=scale)
    return info, hrom


def held_out_mus(rom, n):
    """``n`` of bench.py's 16 Mach-stratified held-out μ
    (``build_sampling_space(16, RandomState(7))``, bench.py:518-521; the
    bins above the box's largest Mach stay empty), evenly spaced in Mach
    from the lowest to the highest."""
    space = rom.build_sampling_space(num=16, rnd=np.random.RandomState(7))
    pick = np.linspace(0, len(space) - 1, n).round().astype(int)
    return [{k: float(v) for k, v in space[i].items()
             if k != "piston_mach"} for i in pick]


def fom_references(fom, mus, dils):
    """Each μ's float64 FOM trajectory (uc, (nt, nh)) on its matched grid
    (T·d, the same nt steps), in one ``solve_fom_batch`` on the FOM's
    device with per-lane clocks."""
    from romtime_tpu_torch.dtypes import compute_dtype_scope
    from romtime_tpu_torch.parallel import solve_fom_batch

    with compute_dtype_scope(torch.float64):
        return list(solve_fom_batch(fom, mus, dilations=dils)["uc"])


def routed_rows_equal_direct(rom, ml, out, mus, cells, Bb):
    """Each occupied cell's direct ``solve_batch`` on its padded
    sub-batch against the routed rows, bit for bit; the largest
    difference (0)."""
    worst = 0.0
    for c in sorted(set(cells.tolist())):
        idx = np.nonzero(cells == c)[0]
        sub = [dict(mus[int(i)]) for i in idx]
        sub = (sub * -(-Bb // len(sub)))[:Bb]
        rom._set_serving_windows(ml.cells[c])
        direct = rom.solve_batch(sub, mode="probes")
        for k, v in direct.items():
            for j, i in enumerate(idx):
                row = np.asarray(out[k][int(i)])
                want_row = v[j] if len(v) == Bb else v
                if not np.array_equal(row, want_row):
                    raise AssertionError(f"cell {c}: routed {k} row {i} "
                                         f"differs from the direct solve")
                worst = max(worst, float(np.abs(row - want_row).max()))
    rom._set_serving_windows(ml.cells[0])
    return worst


@contextlib.contextmanager
def env_scope(name, value):
    """The environment variable ``name`` set to ``value`` inside the
    scope, restored after."""
    saved = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


def probe_lanes(rom, ml, cell, batch_mus, train_mus):
    """The paired-LU probe's lanes on ``cell``
    (scripts/paired_lu_probe.py): the cell's μ of ``batch_mus``, its
    training μ ``train_mus`` and
    FLEET_PROBE_EXTRA more of its μ (seeded draws), cycled to
    FLEET_LANES_B lanes; and the number of distinct μ."""
    from romtime_tpu_torch.testing.synthetic import synthetic_mus

    def in_cell(mus):
        cells = ml.cell_of([rom.compute_piston_mach_number(m) for m in mus])
        return [dict(mus[int(i)]) for i in np.nonzero(cells == cell)[0]]

    batch = in_cell(batch_mus)
    train = [{k: v for k, v in m.items() if k != "piston_mach"}
             for m in train_mus]
    extra, seed = [], 200
    while len(extra) < FLEET_PROBE_EXTRA and seed < 260:
        extra += in_cell(synthetic_mus(2048, seed=seed))
        seed += 1
    distinct = batch + train + extra[:FLEET_PROBE_EXTRA]
    lanes = distinct * -(-FLEET_LANES_B // len(distinct))
    return lanes[:FLEET_LANES_B], len(distinct)


def served_vs_lanes(rom, ml, mus, cells, mods, power, label, built=None):
    """On the cells of FLEET_LANES_CELLS, each padded to FLEET_LANES_B
    from its μ of ``mus``, the served K1 (budget 0, the port's default
    schedule: the per-step LU) against the port's float32 windowed lanes
    engine, at tests/test_windowed.py:91-94's limits. ``built`` (the
    pipeline of a fleet the port built): on the top cell (150x48) the
    reference's default schedule (``ROMTIME_PAIRED_LU=5``: paired LU G=5,
    ``sub1`` followers) is served beside it, its gap to the lanes engine
    measured, not held (the port does not serve it by default); and the
    cell is served on the paired-LU probe's lanes (:func:`probe_lanes`),
    the gaps of the served K1 to the float32 and float64 lanes engines
    printed, not
    held (the reference's kernel misses the float32 limit there by the
    same amount, PERF.md §6), and that launch held against K1's
    twin on the same inputs (ATOL_REL)."""
    from romtime_tpu_torch.rom.engines import windowed_fused as engine

    k1 = mods["k1"]
    wrapper = k1.online_sweep_windowed_fused
    checks = []

    def serve(sub, capture=None):
        n0 = wrapper.serving_launches
        real = engine.online_sweep_windowed_fused

        def spy(*args, **kw):
            out = real(*args, **kw)
            capture.update(args=args, kw=kw, out=out)
            return out

        if capture is not None:
            engine.online_sweep_windowed_fused = spy
        try:
            out = rom.solve_batch(sub, mode="probes")
        finally:
            engine.online_sweep_windowed_fused = real
        if wrapper.serving_launches != n0 + 1:
            raise AssertionError(f"B={FLEET_LANES_B} did not serve on K1")
        return out

    rom.ONLINE_PRECOMPUTE_BUDGET = 0
    try:
        for c in FLEET_LANES_CELLS:
            win = ml.cells[c]
            rom._set_serving_windows(win)
            sub = [dict(mus[int(i)]) for i in np.nonzero(cells == c)[0]]
            sub = (sub * -(-FLEET_LANES_B // len(sub)))[:FLEET_LANES_B]
            top = built is not None and c == FLEET_LANES_CELLS[-1]
            served = serve(sub)
            lanes, lanes_s = timed(rom.device, lambda: rom.solve_batch(
                sub, mode="probes", engine="windowed"))
            scale = max(float(np.abs(lanes["probes"]).max()), 1e-3)
            perr = float(np.abs(served["probes"] - lanes["probes"]).max())
            uerr = float(np.abs(served["uN_final"] - lanes["uN_final"]).max())
            ok = (perr <= FLEET_PROBES_REL * scale and uerr <= FLEET_UN_ATOL
                  and np.isfinite(lanes["probes"]).all())
            row = dict(cell=c, probes_err=perr, probes_limit=(
                FLEET_PROBES_REL * scale), uN_err=uerr, lanes_s=lanes_s)
            if top:
                row.update(served_vs_probe_lanes(rom, ml, c, mus, built, serve,
                                           k1, power, label))
            print(f"  {label} cell {c} {win.n_windows}x{win.N}, B="
                  f"{FLEET_LANES_B}: served K1 vs the float32 lanes engine: "
                  f"probes max abs err {perr:.3e} (limit "
                  f"{FLEET_PROBES_REL * scale:.3e}), uN_final {uerr:.3e} "
                  f"(limit {FLEET_UN_ATOL:.0e}); lanes engine {lanes_s:.1f} "
                  f"s on {power} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"fleet cell {c}: served K1 disagrees "
                                     f"with the lanes engine")
            if top:
                with env_scope("ROMTIME_PAIRED_LU", str(GROUP)):
                    paired = serve(sub)
                gap = np.abs(paired["probes"] - lanes["probes"])
                steps = np.argsort(gap.max(axis=(0, 2)))[-3:][::-1]
                row.update(
                    paired_probes_err=float(gap.max()),
                    paired_uN_err=float(np.abs(
                        paired["uN_final"] - lanes["uN_final"]).max()),
                    paired_worst_steps=steps.tolist())
                print(f"  {label} cell {c}: the reference's default "
                      f"schedule (ROMTIME_PAIRED_LU={GROUP}, sub1 "
                      f"followers) vs the lanes engine: probes "
                      f"{row['paired_probes_err']:.3e}, uN_final "
                      f"{row['paired_uN_err']:.3e}, worst at steps "
                      f"{steps.tolist()} (measured, not served by "
                      f"default)")
            checks.append(row)
            del lanes
            torch.cuda.empty_cache()
    finally:
        del rom.ONLINE_PRECOMPUTE_BUDGET
        rom._set_serving_windows(ml.cells[0])
    return checks


def served_vs_probe_lanes(rom, ml, c, mus, hrom, serve, k1, power, label):
    """Cell ``c`` on the paired-LU probe's lanes: the served K1's gaps to
    the float32 and float64 lanes engines, printed; the launch against
    K1's twin on
    the same inputs, held (ATOL_REL)."""
    from romtime_tpu_torch.dtypes import compute_dtype_scope

    lanes_mus, distinct = probe_lanes(rom, ml, c, mus, hrom.cell_mus[c])
    cap = {}
    served = serve(lanes_mus, cap)
    assert cap["kw"]["paired_lu"] is None, cap["kw"]
    l32, s32 = timed(rom.device, lambda: rom.solve_batch(
        lanes_mus, mode="probes", engine="windowed"))
    with compute_dtype_scope(torch.float64):
        l64, s64 = timed(rom.device, lambda: rom.solve_batch(
            lanes_mus, mode="probes", engine="windowed"))
    scale = float(np.abs(l32["probes"]).max())
    g32 = float(np.abs(served["probes"] - l32["probes"]).max())
    g64 = float(np.abs(served["probes"] - l64["probes"]).max())
    l_gap = float(np.abs(l32["probes"] - l64["probes"]).max())
    print(f"  {label} cell {c}, the paired-LU probe's lanes ({distinct} "
          f"distinct μ: the batch's, the {len(hrom.cell_mus[c])} training "
          f"μ and {FLEET_PROBE_EXTRA} more, cycled to {FLEET_LANES_B}): "
          f"served K1 "
          f"vs the float32 lanes engine {g32:.3e} (the float32 limit "
          f"{FLEET_PROBES_REL * scale:.3e}, not held here), vs the float64 "
          f"lanes engine {g64:.3e}; the two lanes engines {l_gap:.3e} apart "
          f"(lanes {s32:.1f} s float32, {s64:.1f} s float64) on {power}")
    want, twin_s = timed(rom.device, lambda: k1.windowed_fused_reference(
        *cap["args"], **cap["kw"]))
    err = check_sweep(f"  {label} cell {c}: the served K1 launch on the "
                      f"probe's lanes vs its twin on the same inputs "
                      f"({twin_s:.1f} s) on {power}:", cap["out"], want)
    return dict(probe_distinct=distinct, probe_vs_lanes_f32=g32,
                probe_vs_lanes_f64=g64, probe_lanes_f32_vs_f64=l_gap,
                probe_scale=scale, probe_limit=FLEET_PROBES_REL * scale,
                probe_lanes_s=[s32, s64], twin_s=twin_s,
                kernel_vs_twin=err)


@contextlib.contextmanager
def fom_unreachable(fom):
    """``fom.solve`` and ``solve_fom_batch`` raise inside the scope."""
    from romtime_tpu_torch.parallel import sweep

    def boom(*a, **k):
        raise AssertionError("the trajectory cache missed: the FOM ran")

    real = sweep.solve_fom_batch
    fom.solve = boom
    sweep.solve_fom_batch = boom
    try:
        yield
    finally:
        del fom.solve
        sweep.solve_fom_batch = real


def fleet_build_phase(mods, dev, power):
    """Phase 12 of the module doc: the port builds the flagship fleet on
    the card (its depth cut), serves it through K1, checks its accuracy
    against the FOM, certifies it and persists it, in a temporary
    directory. Nothing falls back to the CPU."""
    import tempfile

    from romtime_tpu_torch.conventions import Errors
    from romtime_tpu_torch.dtypes import compute_dtype_scope
    from romtime_tpu_torch.problems import (
        JOINT_CENTER_MU,
        joint_fleet,
        joint_profile,
    )
    from romtime_tpu_torch.rom.hrom import HyperReducedPiston
    from romtime_tpu_torch.rom.windowed import predict_window_floor
    from romtime_tpu_torch.utils import compute_rom_difference

    synth = mods["synth"]
    nt = FLEET_BUILD_GRID["nt"]
    info = {"card": power, "grid": dict(FLEET_BUILD_GRID),
            "per_cell": list(FLEET_BUILD_PER_CELL),
            "register": list(FLEET_BUILD_REGISTER)}
    workdir = tempfile.mkdtemp()
    cwd = os.getcwd()
    try:
        # (a) The global build of the joint profile.
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        hrom, seconds, calls = build_pipeline(dev, FLEET_BUILD_GRID, workdir,
                                              profile="joint_profile")
        rom = hrom.rom
        print(f"fleet build: the joint profile's global build (nx="
              f"{FLEET_BUILD_GRID['nx']}, nt={nt}, float64) on the card: ROM "
              f"N={rom.N}, S-ROM N={hrom.srom.N}; seconds "
              + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items())
              + f"; {calls} snapshot-assembly calls; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB on "
              f"{power}")
        info["global"] = dict(seconds=seconds, snapshot_calls=calls,
                              N=rom.N, N_srom=hrom.srom.N,
                              peak_bytes=torch.cuda.max_memory_allocated())

        # (b) The fleet build: one device sweep, the top cell registered.
        kwargs = joint_fleet(
            per_cell=FLEET_BUILD_PER_CELL, register=FLEET_BUILD_REGISTER,
            cell_wn=FLEET_BUILD_CELL_WN)
        os.chdir(workdir)
        torch.cuda.reset_peak_memory_stats()
        ml, build_s = timed(dev, lambda: hrom.build_mulocal_serving(
            device_sweep=True, **kwargs))
        peak = torch.cuda.max_memory_allocated()
        secs = hrom.fleet_seconds
        print(f"  (b) build_mulocal_serving(device_sweep=True, srom_extra="
              f"{kwargs['srom_extra']}): {build_s:.1f} s; per stage "
              + ", ".join(f"{k} {v:.2f}" for k, v in secs.items())
              + f"; fleet {ml.cell_wn} over S-ROM cells "
              f"{[(w.n_windows, w.N) for w in ml.cells_srom]}, Mach edges "
              f"{np.round(ml.edges, 6).tolist()}; peak device memory "
              f"{peak / 2**30:.3f} GiB on {power}")
        with np.load(os.path.join(workdir, "mulocal_snapshots.npz")) as d:
            build_tag = str(d["build"])
            cached = {c: [d[f"snap_{c}_{j}"] for j in range(int(n))]
                      for c, n in enumerate(d["per_cell"])}
        cells_info = []
        for c, win in enumerate(ml.cells):
            law = win.dilation
            floor = predict_window_floor(cached[c], win.n_windows, win.N)
            mach = [rom.compute_piston_mach_number(m)
                    for m in hrom.cell_mus[c]]
            row = dict(cell=c, shape=f"{win.n_windows}x{win.N}",
                       mach=mach, mus=hrom.cell_mus[c],
                       predicted_floor=floor,
                       law=None if law is None else dict(
                           names=list(law.names),
                           coef=np.asarray(law.coef).tolist(),
                           training_dilations=np.asarray(
                               hrom.cell_dilations[c]).tolist()))
            cells_info.append(row)
            print(f"    cell {c} {row['shape']}: training μ at Mach "
                  + ", ".join(f"{x:.4f}" for x in mach)
                  + f"; predicted floor {floor:.3e} (its standard-clock "
                  f"trajectories); "
                  + ("unregistered" if law is None else
                     f"law {law.names} coef "
                     f"{np.array2string(np.asarray(law.coef), precision=6)}"
                     f", training dilations "
                     f"{np.round(hrom.cell_dilations[c], 5).tolist()}"))
        want_tag = ("device-f32" if torch.device(dev).type == "cuda"
                    else "f64")
        registered = [c for c, w in enumerate(ml.cells)
                      if w.dilation is not None]
        if registered != list(FLEET_BUILD_REGISTER) or build_tag != want_tag:
            raise AssertionError(f"registered cells or cache tag "
                                 f"({build_tag}) not as asked")
        info.update(build_s=build_s, stages=secs, peak_bytes=peak,
                    cells=cells_info, cache_build=build_tag,
                    edges=np.asarray(ml.edges).tolist())

        # (c) Serving at B=2048: a cold call and warm calls through K1.
        Bb = FLEET_BUILD_B
        batches = [synth.synthetic_mus(Bb, seed=61 + r)
                   for r in range(FLEET_CALLS + 1)]
        cell_lists = [ml.cell_of([rom.compute_piston_mach_number(m)
                                  for m in mus]) for mus in batches]
        for c in counters(mods):
            c.launches = c.serving_launches = c.first_design_launches = 0
        times = []
        for mus in batches:
            out, sec = timed(dev, lambda: rom.solve_batch_mulocal(
                mus, mode="probes"))
            times.append(sec)
        launches = [c.launches for c in counters(mods)]
        designs = design_counts(mods)
        want = [sum(len(set(cl.tolist())) for cl in cell_lists), 0, 0, 0, 0]
        cells = cell_lists[-1]
        occupancy = np.bincount(cells, minlength=ml.n_cells).tolist()
        serve = dict(call_info(Bb, times[1:]), cold_ms=times[0] * 1e3,
                     cold_solves_per_s=Bb / times[0], occupancy=occupancy,
                     launches=launches)
        print(f"  (c) serving B={Bb}: cold {times[0] * 1e3:.1f} ms, warm "
              f"median {serve['serve_ms_median']:.1f} ms = "
              f"{serve['solves_per_s']:.1f} solves/s on {power}; occupancy "
              f"{occupancy}; launches K1-K5 {launches}, (serving design, "
              f"first design) {designs}")
        if launches != want or designs["K1"] != (want[0], 0):
            raise AssertionError(f"the built fleet launched {launches} "
                                 f"({designs}), expected {want}")
        check_fleet_rows(out, Bb, ml)
        dil = np.asarray(out["dil"], np.float64)
        # Each registered lane on its law's d(μ) (clamped at the law's
        # floor 1: a μ beyond the training cloud may predict below it),
        # the others on 1.
        reg = np.array([ml.cells[c].dilation is not None for c in cells])
        law_d = np.array([max(float(ml.cells[c].dilation.predict(m)),
                              ml.cells[c].dilation.floor) if r else 1.0
                          for m, c, r in zip(batches[-1], cells, reg)])
        clamped = int((reg & (law_d == 1.0)).sum())
        if (not np.allclose(dil, law_d, rtol=1e-6, atol=0)
                or (dil[reg & (law_d > 1.0)] <= 1.0).any()
                or (dil[~reg] != 1.0).any()
                or clamped):
            raise AssertionError("dilations: registered lanes must carry "
                                 "their law's d > 1, the others 1")
        worst = routed_rows_equal_direct(rom, ml, out, batches[-1], cells, Bb)
        print(f"  (c) routed ≡ direct on every occupied cell (max abs diff "
              f"{worst}, limit 0); {int(reg.sum())} registered lanes at d "
              f"{dil[reg].min():.5f}..{dil[reg].max():.5f} (their laws' "
              f"d(μ), {clamped} at the floor 1), the rest at 1")
        serve["routed_vs_direct_max_abs"] = worst
        serve["served_vs_lanes"] = served_vs_lanes(
            rom, ml, batches[-1], cells, mods, power, "(c)", built=hrom)
        info["serve"] = serve
        last_mus, last_out = batches[-1], out

        # (d) Accuracy against the FOM on the matched grid, float64.
        acc_mus = [dict(JOINT_CENTER_MU)] + held_out_mus(
            rom, FLEET_BUILD_HELD_OUT)
        with compute_dtype_scope(torch.float64):
            full, lanes_s = timed(dev, lambda: rom.solve_batch_mulocal(
                acc_mus, mode="full", engine="windowed"))
        dils = [float(d) for d in np.asarray(full["dil"], np.float64)]
        refs, fom_s = timed(dev, lambda: fom_references(hrom.fom, acc_mus,
                                                        dils))
        acc_cells = ml.cell_of([rom.compute_piston_mach_number(m)
                                for m in acc_mus])
        rels = [float(np.linalg.norm(np.asarray(full["uc"][i]) - refs[i])
                      / np.linalg.norm(refs[i]))
                for i in range(len(acc_mus))]
        rows = [dict(mach=rom.compute_piston_mach_number(m), cell=int(c),
                     dil=d, rel_l2=r)
                for m, c, d, r in zip(acc_mus, acc_cells, dils, rels)]
        print(f"  (d) rel-L2 against the float64 FOM on the matched grid "
              f"(f64 windowed lanes {lanes_s:.1f} s, FOM references "
              f"{fom_s:.1f} s): "
              + "; ".join(f"{'center' if i == 0 else 'held-out'} Mach "
                          f"{r['mach']:.4f} cell {r['cell']} d "
                          f"{r['dil']:.5f}: {r['rel_l2']:.3e}"
                          for i, r in enumerate(rows)))
        bad = [r for i, r in enumerate(rows)
               if (i == 0 and r["rel_l2"] >= FLEET_BUILD_CENTER_REL)
               or (r["dil"] != 1.0
                   and r["rel_l2"] >= FLEET_BUILD_REGISTERED_REL)]
        if bad or not any(r["dil"] != 1.0 for r in rows):
            raise AssertionError(f"(d) the center μ (limit "
                                 f"{FLEET_BUILD_CENTER_REL:.0e}) or a "
                                 f"registered lane (limit "
                                 f"{FLEET_BUILD_REGISTERED_REL:.0e}) missed, "
                                 f"or no registered lane: {bad}")
        print(f"  (d) the center μ under {FLEET_BUILD_CENTER_REL:.0e} and "
              f"the registered lanes under {FLEET_BUILD_REGISTERED_REL:.0e} "
              f"on {power} ok")
        info["accuracy"] = dict(rows=rows, lanes_s=lanes_s, fom_s=fom_s)
        del full, refs

        # (e) estimate_batch_mulocal, float64, B=16: phase 9 (d)'s
        # contract.
        fmus = synth.certification_mus()
        served_before = rom.solve_batch_mulocal(fmus, mode="probes")
        with compute_dtype_scope(torch.float64):
            fest, fest_s = timed(dev, lambda: hrom.estimate_batch_mulocal(
                fmus))
        served_after = rom.solve_batch_mulocal(fmus, mode="probes")
        fe, favg = fest[Errors.ESTIMATOR], fest[Errors.AVERAGE_ESTIMATOR]
        if (fe.shape != (len(fmus), nt) or not np.isfinite(favg).all()
                or (favg <= 0).any()):
            raise AssertionError(f"fleet estimator {fe.shape}: not finite "
                                 f"and > 0")
        for k, v in served_before.items():
            if not all(np.array_equal(a, b)
                       for a, b in zip(v, served_after[k])):
                raise AssertionError(f"served {k} changed across the "
                                     f"estimator")
        fcells = ml.cell_of([rom.compute_piston_mach_number(m)
                             for m in fmus])
        formula = 0.0
        for b, c in enumerate(fcells):
            V_srom = np.asarray(ml.cells_srom[int(c)].Vs)
            uN_b, uNs_b = fest["rom"][b], fest["srom"][b]
            same = np.array([compute_rom_difference(
                uN_b[i], uNs_b[i], V_srom[min(np.searchsorted(
                    ml.cells_srom[int(c)].bounds, i, side="right") - 1,
                    len(V_srom) - 1)]) for i in range(nt)])
            if not np.allclose(fe[b], same, rtol=1e-10, atol=1e-17):
                raise AssertionError(f"fleet μ {b}: the estimator row is "
                                     f"not the reconstruction-norm formula")
            formula = max(formula, float(np.max(
                np.abs(fe[b] - same) / np.maximum(np.abs(same), 1e-300))))
        print(f"  (e) estimate_batch_mulocal, B={len(fmus)}, float64: "
              f"{fest_s:.2f} s a call; averages {float(favg.min()):.4e}.."
              f"{float(favg.max()):.4e}; each row the reconstruction-norm "
              f"formula on its window's basis (largest relative gap "
              f"{formula:.2e}, limit 1e-10); the served fleet equal before "
              f"and after on {power} ok")
        info["estimator"] = dict(B=len(fmus), seconds=fest_s,
                                 formula_rel_gap=formula,
                                 average_min=float(favg.min()),
                                 average_max=float(favg.max()))
        del fest

        # (f) Persistence: a fresh driver resumes the directory; a rebuild
        # at another shape for cell 0 from the trajectory cache; the
        # shapes auto_cell_wn picks from it.
        fresh = HyperReducedPiston(**joint_profile(device=dev,
                                                   **FLEET_BUILD_GRID))
        fresh.setup()
        fresh.setup_hyperreduction()
        fresh.start_from_existing_basis()
        fresh.project_reductors()
        resumed, resume_s = timed(dev, lambda: fresh.rom.solve_batch_mulocal(
            last_mus, mode="probes"))
        for k, v in last_out.items():
            if not all(np.array_equal(a, b) for a, b in zip(v, resumed[k])):
                raise AssertionError(f"the resumed fleet serves another {k}")
        del fresh, resumed
        rebuild_wn = [tuple(FLEET_REBUILD_WN)] + list(kwargs["cell_wn"][1:])
        with fom_unreachable(hrom.fom):
            rebuilt, rebuild_s = timed(dev, lambda: hrom.build_mulocal_serving(
                device_sweep=True, dump=False, snapshot_cache=True,
                local_nmdeim=False,
                **dict(kwargs, cell_wn=rebuild_wn, register=None)))
        rom.mulocal = ml
        if (rebuilt.cell_wn != rebuild_wn
                or not np.array_equal(rebuilt.cells[1].Vs, ml.cells[1].Vs)):
            raise AssertionError("the cached rebuild differs")
        auto_wn, floors = hrom.auto_cell_wn(
            [tuple(w) for w in AUTO_WN_CANDIDATES], AUTO_WN_TARGET,
            expect_n_cells=ml.n_cells, expect_edges=ml.edges)
        print(f"  (f) a fresh driver resumed the directory and served the "
              f"last batch bit for bit ({resume_s:.2f} s, cold); cell 0 "
              f"rebuilt at {FLEET_REBUILD_WN[0]}x{FLEET_REBUILD_WN[1]} from "
              f"the cache with the FOM unreachable in {rebuild_s:.1f} s "
              f"(cell 1's bases bit for bit); auto_cell_wn(candidates "
              f"{[f'{w}x{n}' for w, n in AUTO_WN_CANDIDATES]}, target "
              f"{AUTO_WN_TARGET:.0e}): {auto_wn}, floors "
              + ", ".join(f"{f:.2e}" for f in floors) + f" on {power} ok")
        info["persistence"] = dict(resume_cold_s=resume_s,
                                   rebuild_s=rebuild_s,
                                   rebuild_stages=hrom.fleet_seconds,
                                   auto_cell_wn=[list(w) for w in auto_wn],
                                   auto_floors=floors)
        info["launches"] = launches
    finally:
        os.chdir(cwd)
        shutil.rmtree(workdir, ignore_errors=True)
    return info


def online_single_phase(mods, dev, power, hrom):
    """Phase 13 of the module doc: the single-μ online path, the vmap
    engine and the evaluation half on phase 11's built ROM (the
    throughput profile, float64 built), every launch counter set to 0
    before the phase and read after (no kernel: the reference computes
    all of it outside Pallas)."""
    import tempfile

    from romtime_tpu_torch.conventions import Errors, OperatorType, Stage
    from romtime_tpu_torch.convert import (
        estimator_from_arrays,
        estimator_to_arrays,
    )
    from romtime_tpu_torch.dtypes import compute_dtype_scope
    from romtime_tpu_torch.problems import JOINT_CENTER_MU

    rom = hrom.rom
    mu_val = dict(JOINT_CENTER_MU)
    info = {"card": power, "N": rom.N, "N_srom": hrom.srom.N}
    for c in counters(mods):
        c.launches = c.serving_launches = c.first_design_launches = 0

    # (a) solve in float64 against the lanes engine's row and against the
    # same ROM's solve on the CPU (carried there by its payload).
    f64 = torch.float64
    with compute_dtype_scope(f64):
        _, cold = timed(dev, lambda: rom.solve(mu_val, Stage.ONLINE))
        _, solve_s = timed(dev, lambda: rom.solve(mu_val, Stage.ONLINE))
        sol = rom.solutions
        u64 = np.array(sol.fom)
        lanes, lanes_s = timed(dev, lambda: rom.solve_batch(
            [mu_val], step=Stage.ONLINE, mode="full", engine="lanes"))
        cpu = estimator_from_arrays(estimator_to_arrays(hrom), device="cpu")
        _, cpu_s = timed("cpu", lambda: cpu.rom.solve(mu_val,
                                                      Stage.ONLINE))
    scale = float(np.abs(u64).max())
    vs_lanes = max(float(np.abs(lanes["uc"][0].T - u64).max()),
                   float(np.abs(lanes["uN"][0].T - sol.rom).max()))
    vs_cpu = float(np.abs(cpu.rom.solutions.fom - u64).max())
    ok = vs_lanes <= SINGLE_VS_LANES and vs_cpu <= CERT_F64_REL * scale
    print(f"online single μ: phase 11's ROM (N={rom.N}, S-ROM "
          f"N={hrom.srom.N}, nt={u64.shape[1]}), bench's mu_val")
    print(f"  (a) solve float64: cold {cold * 1e3:.1f} ms, warm "
          f"{solve_s * 1e3:.1f} ms; vs the lanes engine's row "
          f"({lanes_s * 1e3:.1f} ms) max abs {vs_lanes:.3e} (limit "
          f"{SINGLE_VS_LANES:.0e}); vs the CPU solve ({cpu_s * 1e3:.1f} ms) "
          f"{vs_cpu:.3e} (limit {CERT_F64_REL * scale:.3e}) on {power} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("solve disagrees with the lanes engine or the "
                             "CPU")
    info["solve"] = dict(cold_ms=cold * 1e3, warm_ms=solve_s * 1e3,
                         lanes_ms=lanes_s * 1e3, cpu_ms=cpu_s * 1e3,
                         vs_lanes=vs_lanes, vs_cpu=vs_cpu, scale=scale)
    del lanes, cpu

    # (b) float32 (the double-word residual step) against float64; the
    # drift as tests/test_hrom.py:409 and as bench.py:993-996 (over the
    # float64 FOM's norm).
    with compute_dtype_scope(torch.float32):
        _, f32_s = timed(dev, lambda: rom.solve(mu_val, Stage.ONLINE))
    u32 = rom.solutions.fom
    fom = hrom.fom
    with compute_dtype_scope(f64):
        fom.setup()
        fom.update_parametrization(mu_val)
        _, fom_s = timed(dev, fom.solve)
    uh_fom = np.asarray(fom.solutions.fom)
    drift = float(np.linalg.norm(u32 - u64) / np.linalg.norm(u64))
    serve_drift = float(np.linalg.norm(u32 - u64) / np.linalg.norm(uh_fom))
    rel_fom = float(np.linalg.norm(u64 - uh_fom) / np.linalg.norm(uh_fom))
    print(f"  (b) solve float32 (residual form): {f32_s * 1e3:.1f} ms; drift "
          f"from float64 {drift:.3e}; bench's serve_drift (over the "
          f"float64 FOM, {fom_s:.1f} s) {serve_drift:.3e}; the float64 ROM "
          f"vs that FOM {rel_fom:.3e} on {power}")
    if not np.isfinite(u32).all() or drift > F32_DRIFT_MAX:
        raise AssertionError(f"float32 solve drift {drift:.3e}")
    info["f32"] = dict(ms=f32_s * 1e3, drift=drift, serve_drift=serve_drift,
                       fom_s=fom_s, rom_vs_fom=rel_fom)

    # (c) the vmap engine: the ROM without its convection MDEIM (the
    # projection stands in), each row against solve.
    vrom = rom.truncate(0)
    for red, which in ((hrom.mdeim_mass, OperatorType.MASS),
                       (hrom.mdeim_stiffness, OperatorType.STIFFNESS),
                       (hrom.deim_rhs, OperatorType.RHS),
                       (hrom.mdeim_trilinear_lifting,
                        OperatorType.NONLINEAR_LIFTING),
                       (hrom.mdeim_trilinear, OperatorType.TRILINEAR)):
        vrom.add_hyper_reductor(reductor=red, which=which)
    vrom.project_reductors()
    mus = mods["synth"].synthetic_mus(VMAP_B, seed=71)
    engine = vrom._resolve_engine("full", VMAP_B)
    if engine != "vmap":
        raise AssertionError(f"resolved {engine}, not vmap")
    with compute_dtype_scope(f64):
        out, vmap_s = timed(dev, lambda: vrom.solve_batch(mus, mode="full"))
        worst, row_s = 0.0, []
        for i, mu in enumerate(mus):
            _, s = timed(dev, lambda: vrom.solve(mu, Stage.ONLINE))
            row_s.append(s)
            worst = max(worst,
                        float(np.abs(out["uc"][i].T
                                     - vrom.solutions.fom).max()),
                        float(np.abs(out["uN"][i].T
                                     - vrom.solutions.rom).max()))
    ok = worst <= SINGLE_VS_LANES
    print(f"  (c) vmap engine (no convection MDEIM: resolved {engine!r}), "
          f"B={VMAP_B}, float64: {vmap_s * 1e3:.1f} ms a call; each row vs "
          f"solve ({np.median(row_s) * 1e3:.1f} ms each) max abs "
          f"{worst:.3e} (limit {SINGLE_VS_LANES:.0e}) on {power} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("vmap rows disagree with solve")
    info["vmap"] = dict(B=VMAP_B, ms=vmap_s * 1e3,
                        solve_ms_median=float(np.median(row_s)) * 1e3,
                        vs_solve=worst)
    del vrom, out

    # (d) the evaluation half in a temporary directory, float64.
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as workdir:
        os.chdir(workdir)
        try:
            with compute_dtype_scope(f64):
                _, val_s = timed(dev, hrom.evaluate_validation)
                _, onl_s = timed(dev, lambda: hrom.evaluate_online(
                    {"num": EVAL_ONLINE}, rnd=np.random.RandomState(5)))
            hrom.generate_summary()
            files = sorted(os.listdir(workdir))
        finally:
            os.chdir(cwd)
    rows = []
    for which in (Stage.VALIDATION, Stage.ONLINE):
        for idx, e in hrom.errors[which].items():
            rows.append(dict(which=which, idx=idx,
                             rom_mean=float(e[Errors.ROM].mean()),
                             estimator_mean=float(
                                 e[Errors.ESTIMATOR].mean()),
                             finite=bool(np.isfinite(
                                 e[Errors.ESTIMATOR]).all())))
    n_off = len(hrom.rom.mu_space[Stage.OFFLINE])
    online = sorted(hrom.errors[Stage.ONLINE])
    want = ([f"mass_conservation_{w}_fom_{i}.csv"
             for w, idx in ((Stage.VALIDATION, range(n_off)),
                            (Stage.ONLINE, online)) for i in idx]
            + [f"probes_{Stage.ONLINE}_fom_{i}.csv" for i in online]
            + [f"{loc}_probes_comparison_rom_{rom.N}_srom_{hrom.srom.N}_"
               f"trilinear_{hrom.mdeim_trilinear.N}_{Stage.ONLINE}_{i}.csv"
               for loc in ("outflow", "halfway") for i in online])
    missing = sorted(set(want) - set(files))
    ok = (not missing and len(online) == EVAL_ONLINE
          and all(r["rom_mean"] < EVAL_ROM_MEAN and r["finite"]
                  for r in rows))
    print(f"  (d) evaluate_validation ({n_off} μ) {val_s:.1f} s, "
          f"evaluate_online({{'num': {EVAL_ONLINE}}}) {onl_s:.1f} s (the "
          f"float64 FOM per μ): ROM error means "
          + ", ".join(f"{r['which'][:3]} {r['idx']} {r['rom_mean']:.3e}"
                      for r in rows)
          + f" (limit {EVAL_ROM_MEAN:.0e}); estimator means "
          + ", ".join(f"{r['estimator_mean']:.3e}" for r in rows)
          + f", finite; {len(files)} files, the reference's names "
          f"{'present' if not missing else 'MISSING ' + str(missing)}; "
          f"generate_summary: {len(hrom.summary_basis['index'])} bases on "
          f"{power} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the evaluation missed")
    info["evaluation"] = dict(validation_s=val_s, online_s=onl_s, rows=rows,
                              files=len(files))
    info["launches"] = [c.launches for c in counters(mods)]
    return info


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    try:
        from romtime_tpu_torch.ops import global_sweep as gs
        from romtime_tpu_torch.ops import kernel_build
        from romtime_tpu_torch.ops import resid_sweep as rs
        from romtime_tpu_torch.ops import windowed_fused as k1
        from romtime_tpu_torch.testing import synthetic as synth
    except ImportError as exc:
        fail(f"the romtime_tpu_torch package is missing beside "
             f"chip_smoke.py ({exc})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    mods = {"k1": k1, "rs": rs, "gs": gs, "synth": synth}

    power = card()
    print(power)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    built = kernel_build.build_all()
    print(f"built {len(built)} kernel libraries in parallel in "
          f"{time.perf_counter() - t0:.1f} s")
    ptxas = {}
    for src, (path, seconds, log) in built.items():
        print(f"  {path.name} ({src.name}): {seconds:.1f} s")
        ptxas[src.stem] = dict(nvcc_s=seconds,
                               kernels=kernel_build.ptxas_report(log))
        for r in ptxas[src.stem]["kernels"]:
            print(f"    {r['function']}: {r.get('registers')} registers, "
                  f"{r.get('stack')} bytes stack, {r.get('spill_stores')}/"
                  f"{r.get('spill_loads')} bytes spill stores/loads")
    for stem in SERVING_SOURCES:
        spills = [r["function"] for r in ptxas[stem]["kernels"]
                  if r.get("spill_stores") or r.get("spill_loads")]
        if spills or not ptxas[stem]["kernels"]:
            raise AssertionError(f"the serving body spills in {stem}: "
                                 f"{spills}")

    errs = {k: [] for k in KERNELS}
    with torch.inference_mode():
        rich_errs = []
        rows, splits = kernel_phase(mods, dev, power, errs, rich_errs)
        modes, ablations, ledgers = k1_options_phase(mods, dev, power)
        rows += global_kernel_phase(mods, dev, power, errs)
        launches, kernels, serving = serving_phase(mods, dev, power, errs,
                                                   rich_errs)
        gkernels, gserving, rom15, mus = global_serving_phase(mods, dev,
                                                              power, errs)
        autotune = autotune_phase(rom15, mus, repo, power)
        del rom15, mus
        torch.cuda.empty_cache()
        fleet = fleet_phase(mods, dev, power)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        certification = certification_phase(mods, dev, power)
        certification["seconds"] = time.perf_counter() - t0
        print(f"certification phase: {certification['seconds']:.1f} s")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        launches_before = [c.launches for c in counters(mods)]
        fom = fom_phase(dev, power)
        fom["launches"] = [c.launches - n for c, n in
                           zip(counters(mods), launches_before)]
        fom["seconds"] = time.perf_counter() - t0
        print(f"FOM phase: {fom['seconds']:.1f} s, launches K1-K5 "
              f"{fom['launches']} (none: no kernel on the FOM path)")
        if any(fom["launches"]):
            raise AssertionError("the FOM phase launched a serving kernel")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        build, built = offline_build_phase(mods, dev, power)
        build["seconds_phase"] = time.perf_counter() - t0
        print(f"offline build phase: {build['seconds_phase']:.1f} s, "
              f"launches K1-K5 {build['launches']}")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        fleet_build = fleet_build_phase(mods, dev, power)
        fleet_build["seconds_phase"] = time.perf_counter() - t0
        print(f"fleet build phase: {fleet_build['seconds_phase']:.1f} s, "
              f"launches K1-K5 of its served calls "
              f"{fleet_build['launches']}")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        single = online_single_phase(mods, dev, power, built)
        single["seconds_phase"] = time.perf_counter() - t0
        del built
        print(f"online single-μ and evaluation phase: "
              f"{single['seconds_phase']:.1f} s, launches K1-K5 "
              f"{single['launches']} (none: no kernel on this path)")
        if any(single["launches"]):
            raise AssertionError("the single-μ phase launched a serving "
                                 "kernel")
    for k, v in gkernels.items():
        launches[k] = v.pop("launches")
        kernels[k] = v
    serving.update(gserving)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    meta = {
        "K1": ("windowed_serving",
               "romtime_tpu_torch/csrc/windowed_serving.cu",
               "romtime_tpu/ops/pallas_online.py:1303"),
        "K2": ("resid_tables_serving",
               "romtime_tpu_torch/csrc/resid_tables_serving.cu",
               "romtime_tpu/ops/pallas_online.py:962"),
        "K3": ("theta_resid_serving",
               "romtime_tpu_torch/csrc/windowed_serving.cu",
               "romtime_tpu/ops/pallas_online.py:1100"),
        "K4": ("global_tables_serving",
               "romtime_tpu_torch/csrc/global_tables_serving.cu",
               "romtime_tpu/ops/pallas_online.py:184"),
        "K5": ("theta_global_serving",
               "romtime_tpu_torch/csrc/global_serving.cu",
               "romtime_tpu/ops/pallas_online.py:320"),
    }
    # K1 is the serving design; the first design (the other follower
    # modes, the ablations and the ledger) stands beside it as its
    # same-run yardstick.
    kernels["K1"].update(
        richardson_launches=launches.pop("K1_richardson"),
        fleet_launches=fleet["launches"][0],
        richardson_max_abs_err=max(rich_errs),
        phase_shares={shape: {solve: r["shares"] for solve, r in sp.items()}
                      for shape, sp in splits.items()},
        phase_split=splits, ptxas=ptxas["windowed_serving"],
        first_design=dict(source="romtime_tpu_torch/csrc/windowed_fused.cu",
                          ptxas=ptxas["windowed_fused"], modes=modes,
                          ablate=ablations, ledger=ledgers))
    # K2-K5 run on the serving body; their first designs stand beside
    # them as the same-run yardstick (first_design_ms on every row).
    for k, stem, first_src in (
            ("K2", "resid_tables_serving",
             "romtime_tpu_torch/csrc/resid_sweep.cu"),
            ("K3", "windowed_serving", "romtime_tpu_torch/csrc/resid_sweep.cu"),
            ("K4", "global_tables_serving",
             "romtime_tpu_torch/csrc/global_sweep.cu"),
            ("K5", "global_serving", "romtime_tpu_torch/csrc/global_sweep.cu")):
        kernels[k].update(
            ptxas=ptxas[stem],
            phase_split={r["shape"]: r["phase_split"] for r in rows
                         if r["kernel"] == k and "phase_split" in r},
            first_design=dict(source=first_src,
                              ptxas=ptxas[first_src.rsplit("/", 1)[1][:-3]]))
    print(json.dumps({"kernels": [dict(
        name=meta[k][0], route="cuda", source=meta[k][1],
        replaces=meta[k][2], launches=launches[k],
        max_abs_err=max(errs[k]), library_ms=None,
        offline_build_launches=build["launches"][i],
        fleet_build_launches=fleet_build["launches"][i],
        online_single_launches=single["launches"][i], **kernels[k])
        for i, k in enumerate(KERNELS)],
        "shapes": rows, "serving": serving, "autotune": autotune,
        "fleet": fleet, "certification": certification, "fom": fom,
        "offline_build": build, "fleet_build": fleet_build,
        "online_single": single,
        "card": power}, default=float))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
