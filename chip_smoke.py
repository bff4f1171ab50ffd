"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, in order (but for phase 12, which runs after phase 15: its
cold build, (a)-(b), runs in a process of its own, this script with
``--fleet-build DIR`` at nice 10, from the start of phase 9, beside phases 9-11 and
13-15, whose host-clock seconds are taken under its load; (c)-(f) run on
its directory resumed); any failure raises and exits non-zero:

1. the card's name and power limit (nvidia-smi);
2. build of every kernel of the serving paths with nvcc for sm_90a, one
   nvcc per source, all at once, with each source's nvcc seconds: the
   serving body (romtime_tpu_torch/csrc/serving_body.cuh) in K1's serving
   design and K3 (romtime_tpu_torch/csrc/windowed_serving.cu at NP
   8-32, windowed_serving_np48.cu at 40-48, windowed_serving_np64.cu at
   56-64: three units that build in parallel), in K5
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
   over the whole sweep and against the twin on the first 4 windows
   (phase 5 holds the served per-step LU and Richardson calls against
   the twin over the whole sweep); then the serving
   design's phase clocks (its CLOCKED instantiation beside the plain
   one; shares reported where the totals agree within 3%); K2 (B=512 at
   50x32, B=128 at 150x48) and K3 (B=2048) over one window launch with
   step0 > 0 from a nonzero carried state, each on both designs in turns
   (serving, first, first, serving), held against its first design, the
   twin and the split twin, with the serving body's phase clocks (K2's
   serving body on lane-major tables, the conversion from the reference
   layout timed apart; at 50x32 also at 4, 8 and 16 lanes a block); K4
   and K5 over a global sweep of nt=750 (half the flagship grid; phase 6
   sweeps the serving shapes over all 1500 steps): K4 at N=15, K5 at
   N=15 and N=20 (B=2048, the throughput ROM and S-ROM), each also at N=9
   with BDF-1 and no trilinear term, and at B=1000 (not a multiple of
   128),
   each on both designs in turns as K2 and K3, with the phase clocks at
   N=15 (K4) and N=20 (K5). Errors against 5e-5·scale; ms per call of the
   kernel and of the twin, and the bound;
4. K1 options phase (the first design), at both windowed shapes' N and
   window width over half their windows (25x32 and 75x48, B=2048): the
   first design's cost ledger
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
   (``srom_extra=8``, every cell occupied; its time grid cut to nt=150,
   the windows each narrower): shapes, finite positive
   averages, each estimator row the coefficient-difference norm of its
   μ's merged trajectories (rtol 1e-12), a permuted batch's rows bit for
   bit, and the served fleet
   (``solve_batch_mulocal``) equal before and after bit for bit, with
   the per-cell seconds; (e) the chained lanes variant on a 50x32-recipe
   cell with W=7 unequal windows (21 and 22 steps, nt=150), float64, B=16,
   ``mode="reduced"``: card against an explicit CPU run within
   1e-9·scale, and called directly on the equal-width 50x32 cell (nt=150)
   within 1e-9·scale of the equal-width engine;
10. FOM phase, the full-order piston model at the flagship width
   (nx=1000; nt=750, half the flagship's steps; P1, BDF-2, regime
   "rest"; ``convert.piston_fom``)
   over 88 μ drawn from the μ box by the port's ``ParameterSampler``
   (seed 13; the flagship fleet's offline batch, bench.py:113). It runs
   no kernel of K1-K5 (plain torch, as the reference computes the FOM
   outside Pallas). (a) ``solve_fom_batch`` in float32 at B=88, plain
   and with ``dd_sweep``: the reference's keys and shapes, finite, with
   seconds a sweep, ms a step, μ·steps/s and peak device memory; (b) the
   same sweep in float64 on the card for the first 2 μ against an
   explicit CPU run (``device="cpu"``): ``uh``, ``uc``, ``probes`` and
   ``nonlinear_data`` within 1e-10 relative per μ; (c) (a)'s sweeps on
   those 2 μ against (b)'s card sweep (tests/test_fom_dd.py:60-68, :90):
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
   float64 lanes probes within 1e-9·scale; (e) the bench entry's
   throughput path on the built ROM (romtime_tpu_torch/bench.py
   ``measure``, BENCH_PROFILE=throughput, B=2048): the served call through
   K4 or K5 timed by bench.py's chained marginal, the center's float64
   rel-L2 against the float64 FOM and the float32 drift (≤ 1e-5), its
   payload printed, counters read before and after (K4 or K5 alone).
12. fleet build phase: the port builds the flagship μ-local fleet on the
   card from a global ROM it built itself, at bench.py's joint defaults
   and uncut (``problems.joint_profile``/``joint_fleet``, bench.py:64-115,
   :343-400: 12,12,12,12,16,24 training μ, ``register="auto"``), in
   float64 as bench.py builds by default (BENCH_OFFLINE=cpu: every FOM
   sweep of the build a float64 ``fom.solve()`` a μ on the native host
   loop), in a temporary directory kept for phase 16, in a process of
   its own (the build is bound by the host: the float64 FOM solves on
   the native loop and the SVDs on the CPU): (a) the global
   build (nx=1000, nt=1500, 8 offline μ, S-ROM N=96, ROM N=88, N-MDEIM 96
   modes) by phase 11's stages, with each stage's seconds; (b)
   ``build_mulocal_serving(**joint_fleet())``: six Mach cells (50x32 ×4,
   150x48 ×2, ``srom_extra=8``), the seconds of each stage
   (``hrom.fleet_seconds``), each cell's training μ, law and training
   dilations, the registered cells beside
   BENCH_r05.json's and their largest d, peak device memory; held: a
   registered cell, one native float64 solve a training μ and one a
   registered training μ on its dilated grid (the reference's
   re-solves, hrom.py:947-975), the trajectory cache tagged "f64"; that
   process then serves (c)'s last batch on the fleet just built and
   ends; this one waits for it, replays its output and resumes the
   directory with a fresh driver's ``start_from_existing_basis``, which
   serves (c)-(f); (c)
   ``solve_batch_mulocal(mus, mode="probes")`` at B=2048, a cold and 3
   warm calls, every counter set to 0 before the cold call and read
   after the last (one launch of K1's serving design per occupied cell
   and call, no other launch), routed ≡ direct bit for bit, registered
   lanes on their law's d(μ) and the others on 1, and on cells 0 and 5
   at B=128 the
   served K1 (the port's default schedule, the per-step LU) within
   5e-6·scale (``uN_final`` 5e-5) of the float32 lanes engine, and on
   cell 5 the reference's default schedule (``ROMTIME_PAIRED_LU=5``:
   paired LU G=5, ``sub1`` followers) served beside it, its gap
   measured; on cell 5 also the paired-LU probe's lanes
   (scripts/paired_lu_probe.py: the batch's μ of the cell, its 24
   training μ and 40 more of its μ, cycled to 128): that launch's
   probes over its first 4 windows held against K1's twin on the same
   inputs (ATOL_REL; its gaps to the lanes engines there, printed through
   PR 20, are in PERF.md); (d) the bench
   entry's ``measure`` (romtime_tpu_torch/bench.py) on the built fleet,
   the active cell (the center's) attached, counters read before and
   after (K1 alone), its payload printed: bench.py's timed batch
   (bench.py:709-750: its 64-bin draws tiled to 2048) served by the
   chained marginal, the fetch-inclusive variant, the routed fleet call,
   and bench.py's certification (``fleet_certification``,
   bench.py:442-705, :963-995; its FOM references cached in the
   directory) in float64: the
   center μ, bench's 15 held-out μ routed through the windowed lanes
   engine against the float64 FOM on each lane's matched grid, the
   registered lanes also on the standard clock (``resample_to_standard``)
   with the FOM dt-gap, ``estimate_batch_mulocal``'s estimator/true
   ratios, the timed batch's first 16 probe rows against the float64
   lanes engine and the center's float32 drift, each printed beside
   BENCH_r05.json's figure and held at FLEET_CERT_LIMITS (center ≤ 3e-7,
   held-out maxima ≤ 1e-6 on both clocks, ratios in [0.9, 1.1], probe
   error ≤ 1e-5, drift ≤ 1e-5); (e) phase 9 (d)'s contract on that
   estimator: each row the reconstruction-norm formula on its window's
   basis, the served fleet equal before and after; (f) the resumed
   directory serving (c)'s last batch bit for bit as the building
   process served it on the fleet just built; from a cut of the
   trajectory cache (float64; its first
   2,2,2,2,5,5 trajectories a cell, written beside it by the port's cache
   writer) cell 0 rebuilt at 30x40 with ``fom.solve`` and
   ``solve_fom_batch`` unreachable (unregistered, with the box-wide
   N-MDEIM, ``local_nmdeim=False``; cell 1's bases the window POD of its
   cached trajectories bit for bit), and ``auto_cell_wn``'s shapes and
   floors on that cut.
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
   the vmap engine at B=2 on the ROM without its convection MDEIM (the
   projection stands in, ``_resolve_engine`` → "vmap"), each row within
   1e-12 of ``solve`` on its μ; (d) ``hrom.evaluate_validation()`` and
   ``evaluate_online({"num": 1})`` in float64 in a temporary directory:
   each μ's ROM error mean under 5e-3 (tests/test_hrom.py:349), a finite
   estimator, the CSVs the reference names, and ``generate_summary``;
   with the ms of each call. The float64 ``fom.solve()`` of (b) and of
   ``evaluate_online`` runs the native host loop
   (romtime_tpu_torch/csrc/host/, built with g++ into build/native/),
   each call counted; (b) also runs the eager loop on the card
   (``ROMTIME_NATIVE_FOM=0``) and holds the two within 1e-12 relative.
14. heat phase, the MFP1 heat family at the pinned heat size (nx=500,
   nt=1000; tests/goldens/mfp1_convergence_*.csv), fixed and moving:
   (a) the float64 FOM on the card against the same solve on the CPU
   (1e-9·scale), its log10 error at tf against the JAX package's value
   (1e-6) and as close to the golden row as that value is; (b) the port
   builds the HROM on the card in float64 (tests/test_hrom.py
   ``_heat_config`` at half that size each way, nx=250, nt=500, the
   offline μ in one batched sweep); (c) ``solve_batch(mode="probes")`` at
   B=2048 in float32 through K4 (the default budget) and K5 (budget 0),
   ``with_trilinear=False`` and BDF-1, counters zeroed before each branch
   and read after, each launch against its twin (5e-5·scale), the served
   results within 3e-5·scale (``uN_final`` 1e-4·max(|uN|, 1)) of the
   float32 global lanes engine and K5 within 3e-6·scale of K4; (d) on
   the fixed ROM, 4 windows of N=8 served at B=2048 through K1 (budget
   0), one launch, against its twin and within 5e-6·scale (``uN_final``
   5e-5) of the float32 windowed lanes engine, and the float64
   ``engine="windowed"`` within 1e-4 of the FOM; (e) ``estimate_batch``
   in float64 at B=16, the card against the pair carried to the CPU, by
   phase 9's contract.
15. multi-device phase, one controller over a ``parallel.DeviceMesh`` of
   two shards on cuda:0, every launch counter set to 0 before it and
   read after (none: the reference's sharded paths reach no Pallas
   kernel): (a) ``solve_fom_sharded`` at phase 10's FOM (nx=1000,
   nt=750) in float32 over phase 10's first 15 μ (the batch pads to
   16) against phase 10's ``solve_fom_batch`` rows of the same μ within
   1e-12 relative per μ (the same arithmetic a lane); (b) ``orth_distributed`` of (a)'s
   snapshots in float64 on the card (TSQR) against the port's host
   ``orth``: σ within 1e-10 of σ₁, the first 10 modes' spans by the sine
   of their largest principal angle within 1e-8; (c)
   ``solve_online_windowed_sharded`` on the synthetic fleet's 50x32 cell
   0 (phase 9's nt=150) at B=9 in float64 against ``engine="windowed"``
   within 1e-9·scale; (d) the μ-local composition on that fleet, two μ
   in cell 0 and two in the registered cell 5, routed through the
   sharded sweep: each cell's rows (probes, ``uN_final``, ``dil``)
   within 1e-12·scale of its direct single-device rows
   (tests/test_windowed.py:744-779); (e) a mixed mesh, the card and the
   CPU, at tests/test_parallel.py's FOM (nx=64, nt=20) in float64: the
   FOM and the online sweeps (the vmap engine, a seeded 4-mode basis)
   within 1e-10·scale of one device, each shard's μ seen on its own
   device (cuda:0, then cpu); (f) ``parallel.dryrun.dryrun_multichip``
   on the two-shard mesh and on ``device_mesh()`` (the one card), its
   tiny HROM and fleet built on the card once. Each item's seconds and
   gaps beside the card's name and power limit.
16. examples and diagnostics phase, the JAX repository's examples and
   scripts as the port has them (romtime_tpu_torch/examples/,
   romtime_tpu_torch/scripts/, ``parallel.entry``), every launch counter
   read before and after (K1 from the ledger, K4 or K5 from the piston
   example, both held > 0): (a) ``poisson_tutorial`` at nx 16/64/256
   and its POD family on the card against the same functions on the CPU
   (solutions 1e-12 relative, the rounding-level errors within 1e-12 of
   the solution's scale, one mode, the unseen-α reconstruction ≤ 1e-12);
   (b) ``heat_2d`` at nx 16 and 32 the same way; (c) ``piston_rom`` at
   its defaults (nx=300, nt=300): the build, 128 lanes (one 128-lane
   block, its Mach-stratified μ cycled) served through K4 or K5 within
   3e-5·scale (``uN_final`` 1e-4·max(|uN|, 1)) of the float64 global
   lanes engine, the estimator at B=16; then ``--windowed``: the windows
   and two Mach cells, 16 μ routed through the windowed lanes engine,
   routed ≡ direct bit for bit, the per-cell estimator; (d)
   ``mpf1_convergence`` at nx=500, nts 10, 100, 1000 on the goldens' tf,
   fixed and moving, the nt=1000 log10 errors within 1e-6 of the JAX
   package's; (e) on phase 12's fleet directory, resumed warm
   (``permu_diag.build_hrom``): ``permu_diag`` and ``multimu_diag`` on
   the center (phase 12 (d) certifies bench's 15 held-out μ on the same
   fleet; their rel-L2 rows within 1e-12 relative of
   each other, rel² = floor² + in-span² to 1e-12), ``corner_attrib`` at
   10 times, ``window_study`` (the 15:48 floor, then 50:32 served with
   its float32 drift), and ``kernel_ledger``'s inputs on cell 0's real
   tables at B=2048 (K1's phase clocks; each ablation variant against
   its twin on 4 windows within 5e-5·scale; the ablation ledger itself
   runs in (g)); (f) ``entry()``'s forward
   on the card within 1e-10 relative of the CPU's; (g) ``python -m
   romtime_tpu_torch.bench`` in a subprocess, warm on phase 12's
   directory with BENCH_MULTI_MU=0, BENCH_REPEAT=2: its last line
   bench.py's payload keys
   and ``extra.device``, its center rel-L2 phase 12's within 1e-12
   relative, its probe error ≤ 1e-5, its ledger's ``full_us_per_step``
   (the served per-step LU on the serving design) within 25% of (e)'s
   serving LU µs a step. Each item's seconds and gaps beside the card's
   name and power limit.

Every serving branch and the fleet report solves/s (median of the calls,
synchronized) beside the card name, where the time goes, and each
kernel's ms, twin ms and bound on the serving path's own inputs (each on
both designs, in turns). Prints a JSON line of per-kernel results (K1-K5
on the serving body with their first designs' times, the phase shares,
the register and spill report, and K1's first design's modes, ablations
and ledger; the fleet's numbers; the certification, FOM, offline build,
fleet build, online single-μ, heat, multi-device and examples phases'
numbers, the last two under ``multi_device`` and ``examples``), then,
as the last line,
``{"ok": true, "device": {...}}``. Without a CUDA device
it exits non-zero before printing any result. Imports nothing of JAX.
"""

import contextlib
import json
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
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
MODE_REPS = 2        # K1 options phase: timed calls per follower mode
LEDGER_REPS = 2      # calls per ledger variant (median)
OPTION_WINDOWS = 4   # windows of the option-vs-twin comparisons
# The K1 options phase (the first design's modes, ablations and ledger)
# sweeps half of each serving shape's windows, at its width and N: the
# ledger's per-step costs stand as they are, and the smoke run keeps
# within its clock.
OPTION_SHAPES = tuple((W // 2, width, N) for W, width, N in SHAPES)
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
#: (kernel, N, B, nt, options) of the global kernel phase, each over
#: half of the grid (the twins' sweeps dominate the phase, and each step
#: is the same step): the serving shapes (phase 6 sweeps them over the
#: whole grid against both designs, the twin and the split twin), and the
#: BDF-1 and B=1000 variants.
NO_TRI_BDF1 = {"bdf2": False, "with_trilinear": False}
GLOBAL_SHAPES = (("K4", 15, 2048, GLOBAL_NT // 2, {}),
                 ("K5", 15, 2048, GLOBAL_NT // 2, {}),
                 ("K5", 20, 2048, GLOBAL_NT // 2, {}),
                 ("K4", 9, 2048, GLOBAL_NT // 2, NO_TRI_BDF1),
                 ("K5", 9, 2048, GLOBAL_NT // 2, NO_TRI_BDF1),
                 ("K4", 15, 1000, GLOBAL_NT // 2, {}),
                 ("K5", 20, 1000, GLOBAL_NT // 2, {}))
#: Sources of the serving body: no instantiation may spill.
SERVING_SOURCES = ("windowed_serving", "windowed_serving_np48",
                   "windowed_serving_np64", "global_serving",
                   "resid_tables_serving", "global_tables_serving")
#: K1's serving design and K3: one source per NP range, built in parallel.
WINDOWED_SERVING_UNITS = SERVING_SOURCES[:3]
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
# (d)'s nested fleet and (e)'s chained cells at 150 of the 1500 steps
# (the windows keep their count and N, each narrower; the 150x48 cells
# one step a window): (d)'s two 6-cell float64 estimator calls were 122 s
# of the phase at nt=1500 and 36.6 s at nt=450, and the smoke run keeps
# within its clock beside phase 12's uncut fleet (PERF.md §5). Phase 12
# (e) holds the same estimator contract on the built fleet at nt=1500.
CERT_FLEET_GRID = {"nx": 1000, "nt": 150}
SROM_EXTRA = 8
#: (e): unequal widths (W=7 on nt=150: 21 and 22 steps) at N=32.
CHAINED_W = 7
#: Phase 10, the FOM: the flagship piston FOM (bench.py:121-122, :145)
#: over the flagship fleet's offline batch (bench.py:113, 88 μ); (b)-(e)
#: on its first 2 μ, at the limits of the reference tests named there.
# At half the flagship's 1500 steps (its width kept): the sweeps are
# launch-bound, a step a launch sequence, and phases 10 and 15 (a) took
# 55-66 s at nt=1500 (PERF.md §5, PR 21).
FOM_GRID = {"L0": 1.0, "nx": 1000, "tf": 1.0, "nt": 750}
FOM_B = 88
FOM_SEED = 13
FOM_CHECK_B = 2
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
#: Phase 12: the flagship fleet built by the port at bench.py's joint
#: defaults, uncut (bench.py:64-115, :343-400): 12,12,12,12,16,24
#: training μ, every alignable cell registered ("auto"), the training
#: sweep and the global build in float64 on the host's native loop, as
#: bench.py builds by default (BENCH_OFFLINE=cpu, bench.py:231, :403-404).
FLEET_BUILD_GRID = {"nx": 1000, "nt": 1500, "tf": 1.0}
FLEET_BUILD_PER_CELL = (12, 12, 12, 12, 16, 24)
FLEET_BUILD_REGISTER = "auto"
FLEET_BUILD_CELL_WN = ((50, 32),) * 4 + ((150, 48),) * 2
FLEET_BUILD_B = 2048
#: (a)-(b) run in a process of their own (this script with the flag),
#: their output and results in the fleet's directory.
FLEET_BUILD_FLAG = "--fleet-build"
FLEET_BUILD_LOG = "fleet_build.out"
FLEET_BUILD_ERR = "fleet_build.err"
FLEET_BUILD_INFO = "fleet_build.json"
FLEET_BUILD_SERVED = "fleet_build_served.pkl"
FLEET_BUILD_WAIT_S = 900
FLEET_BUILD_NICE = 10
#: (f): cell 0 rebuilt at another shape from the trajectory cache; the
#: shape candidates and target of auto_cell_wn (bench.py:302-313). Both
#: read a cut of the cache, its first trajectories a cell in these
#: counts (the 150x48 windows' stacks need 5 for N=48+8): on the uncut
#: cache they took 30-55 s and 48-78 s (PERF.md §5).
FLEET_REBUILD_WN = (30, 40)
FLEET_REBUILD_PER_CELL = (2, 2, 2, 2, 5, 5)
AUTO_WN_CANDIDATES = ((50, 32), (30, 40), (150, 48))
AUTO_WN_TARGET = 1e-5
# Phase 13: the single-μ path and the evaluation on phase 11's ROM.
SINGLE_VS_LANES = 1e-12   # tests/test_rom.py:114
VMAP_B = 2
EVAL_ONLINE = 1           # μ of evaluate_online (cut from 2; PERF.md §5)
EVAL_ROM_MEAN = 5e-3      # tests/test_hrom.py:349
NATIVE_VS_EAGER = 1e-12   # tests/test_native_fom.py:62-67

# Phase 14: the MFP1 heat family at the pinned heat size of
# tests/goldens/mfp1_convergence_{fixed,moving}.csv (nx=500, nt=1000).
HEAT_GRID = {"L": 2.0, "nx": 500, "nt": 1000}
# (b)-(e): the HROMs built, served and certified at half the goldens'
# size each way (their builds were 35-58 s of the phase at the full size;
# PERF.md §5).
HEAT_BUILD_GRID = {"L": 2.0, "nx": 250, "nt": 500}
HEAT_GOLDEN = {False: -3.360653614949263, True: -4.72751886228184}
# The JAX package's own log10 errors at that size on the CPU
# (scripts/mfp1_golden_gap.py): the goldens predate it by 9.2e-6 and
# 2.2e-5.
HEAT_REF_LOG10 = {False: -3.36066282368192, True: -4.727496660946824}
# A 1e-12 relative trajectory difference (another rounding order) moves
# the log10 of a 1.9e-5 error by ~5e-8; the reference's own note gives
# 7e-7 between two of its solvers (tests/test_fom_heat.py:112-113).
HEAT_LOG10_ATOL = 1e-6
HEAT_B = 2048
HEAT_CALLS = 2
HEAT_SMALL_B = 16
HEAT_WINDOWS = (4, 8)        # tests/test_windowed.py:276
HEAT_WINDOWED_FOM_REL = 1e-4  # tests/test_windowed.py:299
GLOBAL_PROBES_REL = 3e-5     # tests/test_rom.py:196-200
GLOBAL_UN_REL = 1e-4
WINDOWED_PROBES_REL = 5e-6   # tests/test_windowed.py:91-94
WINDOWED_UN_ATOL = 5e-5
# Phase 15: multi-device, one controller over a mesh of the card (two
# shards on cuda:0) and, in (e), a mesh of the card and the CPU.
MD_FOM_B = 15               # (a): pads to 16 (cut from 87; PERF.md §5)
MD_FOM_REL = 1e-12          # (a): the same arithmetic per lane
MD_SIGMA_REL = 1e-10        # (b): TSQR's σ against the host SVD, of σ₁
MD_MODES = 10               # (b): the leading modes whose spans are held
MD_SINE = 1e-8              # (b): sine of their largest principal angle
MD_WINDOWED_B = 9           # (c): pads to 10
MD_LANES_REL = 1e-9         # (c): the float64 lanes limit
MD_ROUTED_CELLS = (0, 5)    # (d): one cell of each shape, 5 registered
MD_ROUTED_REL = 1e-12       # (d): tests/test_windowed.py:744-779
MD_TINY = {"L0": 1.0, "nx": 64, "tf": 0.2, "nt": 20}   # tests/test_parallel.py
MD_MIXED_REL = 1e-10        # (e): card shard against the CPU, float64
# Phase 16: the examples and the diagnostic scripts.
EX_EXACT_REL = 1e-12         # card against CPU, the same float64 code
EX_HEAT2D_NX = (16, 32)      # examples/heat_2d.py:104
EX_PISTON_GRID = {"nx": 300, "nt": 300}   # examples/piston_rom.py:40
EX_PISTON_B = 128            # one 128-lane block: the K4/K5 gate
EX_CERT_B = 16               # the example's estimator batch
EX_HEAT_NTS = (10, 100, 1000)             # the goldens' refinement levels
# permu/multimu_diag's held-out μ beside the center (theirs: 16): phase
# 12 (d) certifies bench's 15 on the same directory.
EX_DIAG_HELD_OUT = 0
EX_CORNER_TIMES = 10         # corner_attrib's times (its own: 40)
EX_STUDY_FLOOR = "15:48"     # window_study's default point
EX_STUDY_SERVED = (50, 32)   # the fleet's 50x32 cell shape
EX_LEDGER_B = 2048           # scripts/kernel_ledger.py's default B
EX_LEDGER_REPS = 3
EX_ENTRY_REL = 1e-10
#: (g): the bench entry warm on phase 12's directory: its center against
#: phase 12's (the same resumed fleet and cached FOM reference), its
#: ledger's served row against the serving LU of (e)'s phase clocks.
EX_BENCH_CENTER_REL = 1e-12
EX_BENCH_LEDGER_REL = 0.25
EX_BENCH_TIMEOUT_S = 600
EX_BENCH_REPEAT = 2          # bench.py's 3 cut: the chains and the ledger


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
# inputs' shapes and values (no loop of these kernels ends early). Both
# count the real n×n block (n = ``n_real``) of the padded NP×NP
# operators, the θ rows that feed it and the real probe rows: the padded
# rows and columns hold zeros and the identity, which the work does not
# need to read or compute.
# ----------------------------------------------------------------------
def lu_fmas(n):
    """FMAs of one lane's pivot-free LU of an n×n matrix and its two
    triangular solves: the least a solve needs (no explicit inverse)."""
    return sum((n - k - 1) * (n - k) for k in range(n)) + n * n


def live_rows(table, NP, n):
    """θ rows that a constant table (θ on its last axis; its rows the NP²
    entries (i, j) of MN or KL, or the NP entries of fN) feeds into the
    real n×n block (the n real rows of fN). A θ row whose column is zero
    there is no work: a row that pads the extent to a multiple of 8, or
    the constant-1 row that carries only the padded diagonal."""
    k = table.shape[-1]
    if table.shape[-2] == NP * NP:
        t = table.reshape(-1, NP, NP, k)[:, :n, :n]
    else:
        t = table.reshape(-1, NP, k)[:, :n]
    return int((t != 0).reshape(-1, k).any(dim=0).sum())


def probe_rows(VE, n):
    """Probe rows of VE (…, PROBE_P, NP) that read the real n columns:
    the probes the work writes (the other rows are zero)."""
    P, NP = VE.shape[-2], VE.shape[-1]
    return int((VE.reshape(-1, P, NP)[:, :, :n] != 0).any(dim=(0, 2)).sum())


def step_fmas(n, km, kk, kf, with_trilinear, solve, p):
    """FMAs of one lane's residual BDF step on the real n×n block with
    each operator formed once from its live θ rows (live_rows): MN = Bm·θm
    and KL = Bk·θk (n²·(km + kk)), fN = Bf·θf (n·kf), the trilinear NN =
    T0·pred and dtS (n³ + n²), KN, MN·d and dtS·pred (3·n²), the solve, and
    the p real probes (p·n). K1, K2 and K3 compute this same step; K2 reads
    MN, KL and fN instead (km = kk = kf = 0)."""
    tri = n ** 3 + n * n if with_trilinear else 0
    return n * n * (km + kk) + n * kf + tri + 3 * n * n + solve + p * n


def bound(flops, nbytes):
    """(least ms, what sets it) against the card's FP32 and HBM peaks."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


#: n² multiples of a paired-LU follower's solve, by mode: one
#: substitution is n² (forward and back), one residual matvec n².
FOLLOWER_NP2 = {"sub1": 3, "warm1": 2, "warm2": 4, "warmx": 2, "inv1": 3,
                "inv2": 5}


def solve_fmas(role, mode, n):
    """FMAs of one lane's solve in a step of ``role`` under paired-LU
    ``mode``: a follower per :data:`FOLLOWER_NP2` (a warmx follower also
    forms 2·δₙ₋₁ − δₙ₋₂, n), an inv leader's inversion and matvec
    (n³ + n²), otherwise an LU with its substitutions."""
    if role == "follow":
        return FOLLOWER_NP2[mode] * n * n + (n if mode == "warmx" else 0)
    if role == "lead" and mode in ("inv1", "inv2"):
        return n ** 3 + n * n
    return lu_fmas(n)


def stream_bytes(nt, Bn, n, p, with_trilinear, carry):
    """Float32 words of what every sweep reads and writes beside its
    operators: g in and the probes out (p real rows a step), T0 (n³, with
    the trilinear term), VE's real block, b0, and the state: the dd carry
    in and out (4 rows each, ``carry``) or the final uN out."""
    return (2 * nt * p * Bn + (n ** 3 if with_trilinear else 0) + p * n
            + Bn + (2 * 4 * n * Bn if carry else n * Bn))


def k1_bound(args, kw):
    """K1 over a whole sweep. A paired-LU step solves as
    :func:`solve_fmas` counts for its role and mode. The Richardson solve
    (``solve_iters`` = m) takes 2m n² matvecs per step, and per window
    K̄'s build from the live θ rows and the trilinear block, its inverse
    (n³, the least an inversion needs) and the δ transfer (n²). The
    window transfers are two dd matvecs through Tp[w] (~10 operations per
    entry). Bytes: the live θ rows and the real g rows of TH, and per
    window the live rows of Bmk and Bf on the real block, T0's n³, Tp's
    n² and VE's real rows (the factored BmF/BkF and TQ carry the same
    constants again)."""
    from romtime_tpu_torch.ops.windowed_fused import step_roles

    TH, Bmk, BfT, VE = args[0], args[1], args[4], args[6]
    nt, _K8, Bn = TH.shape
    W, NP = VE.shape[0], VE.shape[2]                  # VE (W, P, NP)
    n, tri = kw["n_real"], kw["with_trilinear"]
    p = probe_rows(VE, n)
    width = nt // W
    iters = kw.get("solve_iters")
    group = kw.get("paired_lu") or 0
    group = group if group >= 2 and n > 20 else 0
    mode = kw.get("paired_mode", "sub1")
    roles = step_roles(kw.get("period") or width, group)
    solve = sum(solve_fmas(r, mode, n) for r in roles) / len(roles)
    km8, kk8 = kw["km8"], kw["kk8"]                  # Bmk (W, kfold, NP²)
    km = live_rows(Bmk[:, :km8].transpose(1, 2), NP, n)
    kk = live_rows(Bmk[:, km8:km8 + kk8].transpose(1, 2), NP, n)
    kf = live_rows(BfT.transpose(1, 2), NP, n)
    per_window = 2 * 10 * n * n
    if group and mode in ("warm1", "warm2", "warmx"):     # δ transfers
        per_window += n * n * (2 if mode == "warmx" else 1)
    if iters:
        solve = 2 * iters * n * n
        per_window += n * n * (km + kk + (n if tri else 0)) + n ** 3 + n * n
    per_step = step_fmas(n, km, kk, kf, tri, solve, p)
    flops = 2 * Bn * (nt * per_step + W * per_window)
    nbytes = 4 * (nt * (km + kk + kf) * Bn
                  + W * (n * n * (km + kk) + n * kf + n * n)
                  + stream_bytes(nt, Bn, n, p, tri, True)
                  + (W - 1) * ((n ** 3 if tri else 0) + p * n))
    return bound(flops, nbytes)


def k2_bound(args, kw):
    MN, VE = args[0], args[5]
    nt, _NP, _, Bn = MN.shape
    n, tri = kw["n_real"], kw["with_trilinear"]
    p = probe_rows(VE, n)
    per_step = step_fmas(n, 0, 0, 0, tri, lu_fmas(n), p)
    flops = 2 * Bn * nt * per_step
    nbytes = 4 * (nt * (2 * n * n + n) * Bn
                  + stream_bytes(nt, Bn, n, p, tri, True))
    return bound(flops, nbytes)


def theta_words(args, n, nt, Bn):
    """(km, kk, kf, words of the θ rows and constants on the real block)
    of a θ-streaming launch (K3, K5): THm, THk, THf, g, Bm, Bk, Bf, …"""
    Bm, Bk, Bf = args[4:7]
    NP = Bf.shape[0]
    km, kk, kf = (live_rows(Bm, NP, n), live_rows(Bk, NP, n),
                  live_rows(Bf, NP, n))
    return km, kk, kf, (nt * (km + kk + kf) * Bn + n * n * (km + kk)
                        + n * kf)


def k3_bound(args, kw):
    THm, VE = args[0], args[8]
    nt, _km8, Bn = THm.shape
    n, tri = kw["n_real"], kw["with_trilinear"]
    p = probe_rows(VE, n)
    km, kk, kf, words = theta_words(args, n, nt, Bn)
    per_step = step_fmas(n, km, kk, kf, tri, lu_fmas(n), p)
    flops = 2 * Bn * nt * per_step
    nbytes = 4 * (words + stream_bytes(nt, Bn, n, p, tri, True))
    return bound(flops, nbytes)


def global_step_fmas(n, km, kk, kf, with_trilinear, p):
    """FMAs of one lane's plain-f32 global BDF step on n real rows (the
    padded rows and columns hold zeros and the identity, no work): the
    operators MN = Bm·θm, KL = Bk·θk (n²·(km + kk)) and fN = Bf·θf (n·kf)
    over their live θ rows (live_rows) when they are formed, the
    trilinear NN = T0·u* (n³) and its scaled add (n²), KN and the
    MN·combo product (2·n²), a solve (LU and its two substitutions) and
    the p real probe rows (p·n). K4 reads MN, KL and fN instead
    (km = kk = kf = 0)."""
    tri = n ** 3 + n * n if with_trilinear else 0
    return (n * n * (km + kk) + n * kf + tri + 2 * n * n + lu_fmas(n)
            + p * n)


def k4_bound(args, kw):
    MN, VE = args[0], args[5]
    nt, _NP, _, Bn = MN.shape
    n, tri = kw["n_real"], kw["with_trilinear"]
    p = probe_rows(VE, n)
    per_step = global_step_fmas(n, 0, 0, 0, tri, p)
    flops = 2 * Bn * nt * per_step
    nbytes = 4 * (nt * (2 * n * n + n) * Bn
                  + stream_bytes(nt, Bn, n, p, tri, False))
    return bound(flops, nbytes)


def k5_bound(args, kw):
    THm, VE = args[0], args[8]
    nt, _km8, Bn = THm.shape
    n, tri = kw["n_real"], kw["with_trilinear"]
    p = probe_rows(VE, n)
    km, kk, kf, words = theta_words(args, n, nt, Bn)
    per_step = global_step_fmas(n, km, kk, kf, tri, p)
    flops = 2 * Bn * nt * per_step
    nbytes = 4 * (words + stream_bytes(nt, Bn, n, p, tri, False))
    return bound(flops, nbytes)


#: The bound of each global kernel.
GLOBAL_BOUND = {"K4": k4_bound, "K5": k5_bound}


# ----------------------------------------------------------------------
# Kernel phase
# ----------------------------------------------------------------------
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
    from romtime_tpu_torch.scripts.kernel_ledger import first_windows

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
            # The twin over the whole sweep runs in phase 5, on the served
            # per-step LU and Richardson calls.
            row = dict(kernel="K1", solve=solve, shape=shape, B=B, ms=ms,
                       first_design_ms=first_ms)
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
                  f"bound {bms:.3f} ms ({by}){extra}")
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
    windowed shapes' N and width over half their windows
    (:data:`OPTION_SHAPES`): each mode's time, bound
    and probe gap to the per-step LU and to sub1 over a whole sweep; each
    mode and each ablation (with the LU schedule and with Richardson)
    against its twin on the first OPTION_WINDOWS windows; the cost ledger
    (romtime_tpu_torch/kernel_ledger.py). Returns (modes, ablations,
    ledgers)."""
    from romtime_tpu_torch.kernel_ledger import kernel_ledger, ledger_lines
    from romtime_tpu_torch.scripts.kernel_ledger import first_windows

    k1, synth = mods["k1"], mods["synth"]
    wrapper, twin = k1.online_sweep_windowed_fused, k1.windowed_fused_reference
    modes, ablations, ledgers = [], [], {}
    for W, width, N in OPTION_SHAPES:
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
    for name, N, Bn, nt, options in GLOBAL_SHAPES:
        bnd = GLOBAL_BOUND[name]
        args, kw = synth.global_tables(N, nt, Bn, seed=N, device=dev,
                                       theta=name == "K5", **options)
        label = (f"{name} N={N} nt={nt} B={Bn}"
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
        rows.append(dict(kernel=name, shape=f"N{N}", B=Bn, nt=nt,
                         options=options, bound_ms=bms, bound_by=by, **row))
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
        device=dev, srom_extra=SROM_EXTRA, **CERT_FLEET_GRID))
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
    if (fe.shape != (CERT_SMALL_B, CERT_FLEET_GRID["nt"])
            or favg.shape != (CERT_SMALL_B,)
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
                                      device=d, **CERT_FLEET_GRID)
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
    cell = synth.synthetic_cell(device=dev, **CERT_FLEET_GRID)
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

    # (a) float32 at the full batch, plain and dd; the first μ kept, and
    # the plain sweep's first MD_FOM_B rows for phase 15 (a).
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
        if not dd:
            batch = {k: v[:MD_FOM_B] for k, v in out.items()}
        del out
        info[f"f32_{label}"] = dict(
            seconds=sec, ms_per_step=sec / nt * 1e3,
            mu_steps_per_s=FOM_B * nt / sec, peak_bytes=peak)
        print(f"  (a) solve_fom_batch float32 {label}, B={FOM_B}: "
              f"{sec:.2f} s a sweep, {sec / nt * 1e3:.3f} ms a step, "
              f"{FOM_B * nt / sec:.1f} μ·steps/s, peak device memory "
              f"{peak / 2**30:.2f} GiB; keys and shapes as the reference's, "
              f"finite, on {power} ok")

    # (b) float64, the first μ, the card against the CPU.
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
    return info, batch


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


def build_pipeline(dev, grid, workdir, profile="throughput_profile",
                   device_sweep=True):
    """bench.py's offline sequence (bench.py:209-262) with the port on
    ``dev`` in ``workdir`` for ``problems.<profile>``, the FOM sweep one
    batch on the device (``device_sweep``, bench.py's BENCH_OFFLINE=device)
    or a float64 ``fom.solve()`` a μ (bench.py's default): returns the
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
        timed(dev, lambda: hrom.run_offline_rom(device_sweep=device_sweep))
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

    from romtime_tpu_torch import bench as pb
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

    # (e) The bench entry's throughput path (romtime_tpu_torch/bench.py
    # ``measure``, BENCH_PROFILE=throughput) on the built ROM: the served
    # call through K4 or K5 timed by bench.py's chained marginal, the
    # center's float64 accuracy and the float32 drift, every counter read
    # before and after (K4 or K5, no other).
    cfg = pb.settings({"BENCH_PROFILE": "throughput",
                       "BENCH_NX": str(BUILD_GRID["nx"]), "BENCH_NT": str(nt),
                       "BENCH_ONLINE_MU": str(BUILD_B)})
    before = launch_counts(mods)
    entry, entry_s = timed(dev, lambda: pb.measure(
        hrom, cfg, dict(offline_wall=sum(seconds.values()), n_windows=0,
                        window_n=0), card=power))
    entry_launches = launches_since(mods, before)
    payload = entry["payload"]
    extra = payload["extra"]
    ok = (tuple(payload) == pb.PAYLOAD_KEYS
          and tuple(extra) == pb.EXTRA_KEYS and extra["engine"] == "pallas"
          and not any(entry_launches[:3])
          and entry_launches[3] + entry_launches[4] > 0
          and np.isfinite(payload["rel_l2_vs_fom"])
          and extra["f32_serving_drift"] <= pb.F32_DRIFT_MAX)
    print(f"  (e) the bench entry's throughput path on the built ROM in "
          f"{entry_s:.1f} s: {payload['value']} solves/s (engine "
          f"{extra['engine']!r}, B={BUILD_B}, "
          f"{extra['online_sweep_wall_s']} s a served call, fetch-inclusive "
          f"{extra['fetch_inclusive']['solves_per_sec']} solves/s), center "
          f"rel-L2 {payload['rel_l2_vs_fom']:.4e}, float32 drift "
          f"{extra['f32_serving_drift']:.3e} (limit {pb.F32_DRIFT_MAX:g}); "
          f"launches K1-K5 {entry_launches} on {power} "
          f"{'ok' if ok else 'FAIL'}; its payload:")
    print("    " + json.dumps(payload, default=float))
    if not ok:
        raise AssertionError("the entry's throughput path failed")
    info["entry"] = dict(payload=payload, launches=entry_launches,
                         seconds=entry_s)
    info["launches"] = [a + b for a, b in zip(info["launches"],
                                              entry_launches)]
    return info, hrom


def routed_rows_equal_direct(rom, ml, out, mus, cells, Bb, engine=None):
    """Each occupied cell's direct ``solve_batch`` (on ``engine``, default
    the resolved one) on its padded sub-batch against the routed rows, bit
    for bit; the largest difference (0)."""
    worst = 0.0
    for c in sorted(set(cells.tolist())):
        idx = np.nonzero(cells == c)[0]
        sub = [dict(mus[int(i)]) for i in idx]
        sub = (sub * -(-Bb // len(sub)))[:Bb]
        rom._set_serving_windows(ml.cells[c])
        direct = rom.solve_batch(sub, mode="probes", engine=engine)
        for k, v in direct.items():
            if len(v) != Bb and np.shape(out[k]) == np.shape(v):
                # An output shared by the lanes (the lanes engine's t).
                if not np.array_equal(np.asarray(out[k]), v):
                    raise AssertionError(f"cell {c}: routed {k} differs "
                                         f"from the direct solve")
                continue
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
    that launch's probes over its first OPTION_WINDOWS windows held
    against K1's twin on the same inputs (ATOL_REL)."""
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
    """Cell ``c`` on the paired-LU probe's lanes: the served K1 launch's
    probes over its first OPTION_WINDOWS windows against K1's twin on the
    same inputs, held (ATOL_REL). (Its gaps to the lanes engines on these
    lanes, measured through PR 20, are in PERF.md.)"""
    from romtime_tpu_torch.scripts.kernel_ledger import first_windows

    lanes_mus, distinct = probe_lanes(rom, ml, c, mus, hrom.cell_mus[c])
    cap = {}
    serve(lanes_mus, cap)
    assert cap["kw"]["paired_lu"] is None, cap["kw"]
    # The twin on the launch's inputs over its first OPTION_WINDOWS
    # windows (the whole 150-window sweep takes 18 s): the
    # launch's probe rows of those windows.
    a4, kw4 = first_windows(cap["args"], cap["kw"], OPTION_WINDOWS)
    (want, _), twin_s = timed(rom.device, lambda: k1.windowed_fused_reference(
        *a4, **kw4))
    print(f"  {label} cell {c}: the served K1 launch on the paired-LU "
          f"probe's lanes ({distinct} distinct μ: the batch's, the "
          f"{len(hrom.cell_mus[c])} training μ and {FLEET_PROBE_EXTRA} more, "
          f"cycled to {FLEET_LANES_B}) vs its twin on the same inputs, the "
          f"first {OPTION_WINDOWS} windows ({twin_s:.1f} s) on {power}:")
    err = check("probes", cap["out"][0][:len(want)], want)
    return dict(probe_distinct=distinct, twin_s=twin_s, kernel_vs_twin=err)


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


def fleet_batches(synth):
    """(c)'s batches of the fleet phase: a cold call's μ, then
    FLEET_CALLS warm calls' (the build's process serves the last)."""
    return [synth.synthetic_mus(FLEET_BUILD_B, seed=61 + r)
            for r in range(FLEET_CALLS + 1)]


def fleet_cold_build(mods, dev, power, workdir):
    """Phase 12 (a)-(b) of the module doc, in the process that
    :func:`start_fleet_build` starts: the flagship fleet's cold build on
    the card at bench.py's joint defaults (float64, uncut) in
    ``workdir``, held as the module doc says, then (c)'s last batch
    served on the fleet just built. Writes FLEET_BUILD_INFO (each
    stage's seconds, the cells, the registered ones) and
    FLEET_BUILD_SERVED (that call's rows) into ``workdir``."""
    from romtime_tpu_torch import bench as pb
    from romtime_tpu_torch.problems import joint_fleet

    nt = FLEET_BUILD_GRID["nt"]
    info = {"card": power, "grid": dict(FLEET_BUILD_GRID),
            "per_cell": list(FLEET_BUILD_PER_CELL),
            "register": FLEET_BUILD_REGISTER}
    cwd = os.getcwd()
    try:
        # (a) The global build of the joint profile, its FOM sweep a
        # float64 fom.solve() a μ.
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        hrom, seconds, calls = build_pipeline(dev, FLEET_BUILD_GRID, workdir,
                                              profile="joint_profile",
                                              device_sweep=False)
        rom = hrom.rom
        print(f"fleet build: the joint profile's global build (nx="
              f"{FLEET_BUILD_GRID['nx']}, nt={nt}, float64, the FOM sweep a "
              f"float64 fom.solve() a μ) on the card: ROM "
              f"N={rom.N}, S-ROM N={hrom.srom.N}; seconds "
              + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items())
              + f"; {calls} snapshot-assembly calls; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB on "
              f"{power}")
        info["global"] = dict(seconds=seconds, snapshot_calls=calls,
                              N=rom.N, N_srom=hrom.srom.N,
                              peak_bytes=torch.cuda.max_memory_allocated())

        # (b) The fleet build at bench's defaults: the training sweep a
        # float64 fom.solve() a μ (the native host loop), every alignable
        # cell registered.
        kwargs = joint_fleet(
            per_cell=FLEET_BUILD_PER_CELL, register=FLEET_BUILD_REGISTER,
            cell_wn=FLEET_BUILD_CELL_WN)
        os.chdir(workdir)
        torch.cuda.reset_peak_memory_stats()
        native_calls = mods["native"].calls["piston_fom_solve"]
        ml, build_s = timed(dev, lambda: hrom.build_mulocal_serving(**kwargs))
        native_calls = mods["native"].calls["piston_fom_solve"] - native_calls
        peak = torch.cuda.max_memory_allocated()
        secs = hrom.fleet_seconds
        print(f"  (b) build_mulocal_serving(per_cell "
              f"{list(FLEET_BUILD_PER_CELL)}, register="
              f"{FLEET_BUILD_REGISTER!r}, srom_extra={kwargs['srom_extra']}):"
              f" {build_s:.1f} s; per stage "
              + ", ".join(f"{k} {v:.2f}" for k, v in secs.items())
              + f"; {native_calls} native float64 FOM solves (the "
              f"training μ, then the registered ones on their dilated "
              f"grids); fleet "
              f"{ml.cell_wn} over S-ROM cells "
              f"{[(w.n_windows, w.N) for w in ml.cells_srom]}, Mach edges "
              f"{np.round(ml.edges, 6).tolist()}; peak device memory "
              f"{peak / 2**30:.3f} GiB on {power}")
        cache_path = os.path.join(workdir, "mulocal_snapshots.npz")
        with np.load(cache_path) as d:
            build_tag = str(d["build"])
        cells_info = []
        for c, win in enumerate(ml.cells):
            law = win.dilation
            mach = [rom.compute_piston_mach_number(m)
                    for m in hrom.cell_mus[c]]
            row = dict(cell=c, shape=f"{win.n_windows}x{win.N}",
                       mach=mach, mus=hrom.cell_mus[c],
                       law=None if law is None else dict(
                           names=list(law.names),
                           coef=np.asarray(law.coef).tolist(),
                           training_dilations=np.asarray(
                               hrom.cell_dilations[c]).tolist()))
            cells_info.append(row)
            print(f"    cell {c} {row['shape']}: {len(mach)} training μ at "
                  f"Mach {min(mach):.4f}..{max(mach):.4f}; "
                  + ("unregistered" if law is None else
                     f"law {law.names} coef "
                     f"{np.array2string(np.asarray(law.coef), precision=6)}"
                     f", training dilations "
                     f"{np.min(hrom.cell_dilations[c]):.5f}.."
                     f"{np.max(hrom.cell_dilations[c]):.5f}"))
        registered = [c for c, w in enumerate(ml.cells)
                      if w.dilation is not None]
        d_max = max((float(np.max(hrom.cell_dilations[c]))
                     for c in registered), default=1.0)
        print(f"  (b) registered cells {registered} (BENCH_r05: "
              f"{pb.BENCH_R05['registered_cells']}), the largest training d "
              f"{d_max:.5f}; the trajectory cache's build tag {build_tag!r}"
              f" (float64)")
        # A native float64 solve a training μ, and one a registered
        # training μ on its dilated grid.
        want_native = sum(FLEET_BUILD_PER_CELL) + sum(
            len(hrom.cell_dilations[c]) for c in registered)
        if (not registered or build_tag != "f64"
                or native_calls != want_native):
            raise AssertionError(f"no registered cell, or the training "
                                 f"sweep and re-solves were not float64 a μ"
                                 f" (tag {build_tag}, {native_calls} native "
                                 f"solves of {want_native})")
        info.update(build_s=build_s, stages=secs, peak_bytes=peak,
                    cells=cells_info, cache_build=build_tag,
                    native_solves=native_calls, registered=registered,
                    d_max=d_max, edges=np.asarray(ml.edges).tolist())
        info["offline_wall"] = sum(seconds.values()) + build_s
        # (f)'s yardstick: (c)'s last batch on the fleet as built.
        last = fleet_batches(mods["synth"])[-1]
        out, info["served_s"] = timed(dev, lambda: rom.solve_batch_mulocal(
            last, mode="probes"))
        with open(os.path.join(workdir, FLEET_BUILD_SERVED), "wb") as f:
            pickle.dump(out, f)
        with open(os.path.join(workdir, FLEET_BUILD_INFO), "w") as f:
            json.dump(info, f, default=float)
    finally:
        os.chdir(cwd)


def start_fleet_build(workdir):
    """Phase 12 (a)-(b) started in a process of its own (this script with
    FLEET_BUILD_FLAG, which runs :func:`fleet_cold_build`), its standard
    output and error into ``workdir``. The build is bound by the host
    (the float64 FOM solves on the native loop, the SVDs on the CPU), so
    it runs beside phases 9-11 and 13-15, at a lower priority
    (FLEET_BUILD_NICE). Returns the process."""
    with open(os.path.join(workdir, FLEET_BUILD_LOG), "w") as out, \
            open(os.path.join(workdir, FLEET_BUILD_ERR), "w") as err:
        return subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()),
             FLEET_BUILD_FLAG, workdir], stdout=out, stderr=err, cwd=workdir)


def fleet_build_phase(mods, dev, power, workdir, builder):
    """Phase 12 of the module doc: the flagship fleet that ``builder``
    (:func:`start_fleet_build`) built on the card at bench.py's joint
    defaults (float64, uncut) in ``workdir``, resumed here from that
    directory, served through K1, timed and certified as bench.py does
    (the bench entry's ``measure``, held at its FLEET_CERT_LIMITS); the
    directory stays for phase 16. Nothing falls back to the CPU."""
    from romtime_tpu_torch import bench as pb
    from romtime_tpu_torch.conventions import Errors
    from romtime_tpu_torch.problems import (
        JOINT_CENTER_MU,
        joint_fleet,
        joint_profile,
    )
    from romtime_tpu_torch.rom.hrom import HyperReducedPiston
    from romtime_tpu_torch.utils import compute_rom_difference

    synth = mods["synth"]
    nt = FLEET_BUILD_GRID["nt"]
    t_w = time.perf_counter()
    try:
        rc = builder.wait(timeout=FLEET_BUILD_WAIT_S)
    except subprocess.TimeoutExpired:
        builder.kill()
        builder.wait()
        rc = f"killed after {FLEET_BUILD_WAIT_S} s"
    waited = time.perf_counter() - t_w
    with open(os.path.join(workdir, FLEET_BUILD_LOG)) as f:
        print(f.read(), end="", flush=True)
    with open(os.path.join(workdir, FLEET_BUILD_ERR)) as f:
        err = f.read()
    sys.stderr.write(err)
    sys.stderr.flush()
    if rc != 0:
        raise AssertionError(f"the fleet build's process ended with {rc}:"
                             f" {err[-3000:]}")
    with open(os.path.join(workdir, FLEET_BUILD_INFO)) as f:
        info = json.load(f)
    kwargs = joint_fleet(
        per_cell=FLEET_BUILD_PER_CELL, register=FLEET_BUILD_REGISTER,
        cell_wn=FLEET_BUILD_CELL_WN)
    cwd = os.getcwd()
    try:
        # The build's directory resumed by a fresh driver, as the bench
        # entry resumes it warm; its training μ from the trajectory cache.
        os.chdir(workdir)
        hrom = HyperReducedPiston(**joint_profile(device=dev,
                                                  **FLEET_BUILD_GRID))
        _, resume_s = timed(dev, lambda: (
            hrom.setup(), hrom.setup_hyperreduction(),
            hrom.start_from_existing_basis(), hrom.project_reductors()))
        rom = hrom.rom
        ml = rom.mulocal
        registered = ([] if ml is None else
                      [c for c, w in enumerate(ml.cells)
                       if w.dilation is not None])
        if (ml is None or ml.cell_wn != [tuple(w) for w in kwargs["cell_wn"]]
                or registered != info["registered"]):
            raise AssertionError(f"the resumed fleet is not the one built "
                                 f"({None if ml is None else ml.cell_wn}, "
                                 f"registered {registered})")
        cache_path = os.path.join(workdir, "mulocal_snapshots.npz")
        with np.load(cache_path) as d:
            keys = [str(k) for k in d["mu_keys"]]
            hrom.cell_mus = {c: [dict(zip(keys, map(float, row)))
                                 for row in d[f"mus_{c}"]]
                             for c in range(ml.n_cells)}
        build_tag = info["cache_build"]
        info.update(wait_s=waited, resume_s=resume_s)
        print(f"  (b) built in a process of its own beside phases 9-11 and "
              f"13-15 (phase 12 waited {waited:.1f} s for it); its directory "
              f"resumed here by a fresh HyperReducedPiston in "
              f"{resume_s:.1f} s: fleet {ml.cell_wn}, registered "
              f"{registered}")

        # (c) Serving at B=2048: a cold call and warm calls through K1.
        t_c = time.perf_counter()
        Bb = FLEET_BUILD_B
        batches = fleet_batches(synth)
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
                or (dil[~reg] != 1.0).any()):
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
        serve["seconds"] = time.perf_counter() - t_c
        print(f"  (c) in {serve['seconds']:.1f} s")
        info["serve"] = serve
        last_out = out

        # (d) bench.py's timing and certification through the bench
        # entry's measure (romtime_tpu_torch/bench.py) on this fleet, the
        # active cell (the center's) attached, every counter read before
        # and after (K1 alone), its FOM references cached in the
        # directory for phase 16 (g); held at FLEET_CERT_LIMITS. (e)
        # phase 9 (d)'s contract on its estimator: each row the
        # reconstruction-norm formula on its window's basis, the served
        # fleet equal before and after.
        active = int(ml.cell_of(rom.compute_piston_mach_number(
            JOINT_CENTER_MU)))
        cfg = pb.settings({"BENCH_NX": str(FLEET_BUILD_GRID["nx"]),
                           "BENCH_NT": str(nt), "BENCH_LEDGER": "0",
                           "BENCH_ONLINE_MU": str(Bb)})
        cert_mus = pb.bench_mus(rom, pb.FLEET_CERT_BINS, 7)
        served_before = rom.solve_batch_mulocal(cert_mus, mode="probes")
        before = launch_counts(mods)
        rom._set_serving_windows(ml.cells[active])
        try:
            entry, cert_s = timed(dev, lambda: pb.measure(
                hrom, cfg, dict(offline_wall=info["offline_wall"],
                                n_windows=ml.cell_wn[active][0],
                                window_n=ml.cell_wn[active][1]),
                cache_dir=workdir, card=power))
        finally:
            rom._set_serving_windows(ml.cells[0])
        entry_launches = launches_since(mods, before)
        served_after = rom.solve_batch_mulocal(cert_mus, mode="probes")
        payload, cert, fest = entry["payload"], entry["cert"], entry["est"]
        extra = payload["extra"]
        print(f"  (d) the bench entry's measure on the built fleet in "
              f"{cert_s:.1f} s, launches K1-K5 {entry_launches}: "
              f"{payload['value']} solves/s on the active cell {active} "
              f"({extra['n_windows']}x{extra['window_n']}, B={Bb}, "
              f"{extra['online_sweep_wall_s']} s a served call), "
              f"fetch-inclusive {extra['fetch_inclusive']['solves_per_sec']}"
              f" solves/s, the routed fleet call "
              f"{entry['fleet']['warm_median_s'] * 1e3:.1f} ms (first "
              f"{entry['fleet']['cold_s'] * 1e3:.1f} ms) on {power}; its "
              f"payload:")
        print("    " + json.dumps(payload, default=float))
        if not entry_launches[0] or any(entry_launches[1:]):
            raise AssertionError(f"the entry launched {entry_launches}, "
                                 f"expected K1 only")
        # K1's launches on the main path: the fleet's calls and the entry's.
        launches = [a + b for a, b in zip(launches, entry_launches)]
        info["entry"] = dict(payload=payload, launches=entry_launches,
                             seconds=cert_s, fleet=entry["fleet"])
        del entry
        sec = cert["seconds"]
        multi = cert["rel_l2_multi_mu"]
        std = multi.get("std") or {}
        print(f"  (d) bench's certification (float64 lanes"
              f": the center {sec['center_lanes']:.1f} s, {multi['n']} "
              f"held-out μ {sec['held_out_lanes']:.1f} s, the probe rows "
              f"{sec['probe_lanes']:.1f} s; the FOM references "
              f"{sec['fom_references']:.1f} s; estimate_batch_mulocal "
              f"{sec['estimator']:.1f} s; float32 lanes "
              f"{sec['f32_lanes']:.1f} s); active cell "
              f"{cert['active_cell']}, the center's d "
              f"{cert['center_dil']:.5f}")
        for r in cert["rows"]:
            print(f"    Mach {r['mach']:.4f} cell {r['cell']} d "
                  f"{r['dil']:.5f}: rel-L2 {r['rel_l2']:.4e}"
                  + ("" if r["rel_l2_std"] is None else
                     f", standard clock {r['rel_l2_std']:.4e} (FOM dt-gap "
                     f"{r['fom_dt_gap']:.3e})")
                  + f", estimator/true {r['ratio']:.4f}")
        print(f"  (d) center rel-L2 {cert['rel_l2_vs_fom']:.4e}; {multi['n']}"
              f" μ mean {multi['mean']:.4e} max {multi['max']:.4e}, "
              f"{multi['n_registered']} registered, d max "
              f"{multi['dil_max']:.5f}, n_dil_flagged "
              f"{multi['n_dil_flagged']}; standard clock mean "
              f"{std.get('mean', float('nan')):.4e} max "
              f"{std.get('max', float('nan')):.4e}, FOM dt-gap mean "
              f"{std.get('fom_dt_gap_mean', float('nan')):.3e} max "
              f"{std.get('fom_dt_gap_max', float('nan')):.3e} (BENCH_r05 "
              f"{pb.BENCH_R05['fom_dt_gap_max']:.3e}); avg_estimator_mean "
              f"{cert['windowed_estimator']['avg_estimator_mean']:.4e}")
        pb.hold_certification(cert, power)
        for k, v in served_before.items():
            if not all(np.array_equal(a, b)
                       for a, b in zip(v, served_after[k])):
                raise AssertionError(f"served {k} changed across the "
                                     f"estimator")
        fe = fest[Errors.ESTIMATOR]
        fcells = ml.cell_of([rom.compute_piston_mach_number(m)
                             for m in cert_mus])
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
        print(f"  (e) each estimator row the reconstruction-norm formula on "
              f"its window's basis (largest relative gap {formula:.2e}, "
              f"limit 1e-10); the served fleet equal before and after on "
              f"{power} ok")
        cert.update(seconds_total=cert_s, formula_rel_gap=formula)
        info["certification"] = cert
        del fest

        # (f) Persistence: the fleet served here (the directory resumed)
        # against the building process's own call on the fleet it had
        # just built; a rebuild at another shape for cell 0 from the
        # trajectory cache; the shapes auto_cell_wn picks from it.
        with open(os.path.join(workdir, FLEET_BUILD_SERVED), "rb") as f:
            built_out = pickle.load(f)
        if set(built_out) != set(last_out):
            raise AssertionError(f"the resumed fleet serves {set(last_out)}"
                                 f", the build {set(built_out)}")
        for k, v in built_out.items():
            if len(v) != len(last_out[k]) or not all(
                    np.array_equal(a, b) for a, b in zip(v, last_out[k])):
                raise AssertionError(f"the resumed fleet serves another {k}"
                                     f" than the fleet as built")
        del built_out
        # The rebuild and auto_cell_wn read a cut of (b)'s trajectory
        # cache, its first FLEET_REBUILD_PER_CELL trajectories a cell,
        # written beside it by the port's own cache writer.
        rebuild_wn = [tuple(FLEET_REBUILD_WN)] + list(kwargs["cell_wn"][1:])
        per_cut = list(FLEET_REBUILD_PER_CELL)
        with np.load(cache_path) as d:
            keys = [str(k) for k in d["mu_keys"]]
            cut_mus = {c: [dict(zip(keys, map(float, row)))
                           for row in d[f"mus_{c}"][:k]]
                       for c, k in enumerate(per_cut)}
            cut_snaps = {c: [np.asarray(d[f"snap_{c}_{j}"], np.float64)
                             for j in range(k)]
                         for c, k in enumerate(per_cut)}
        cut_dir = os.path.join(workdir, "cache_cut")
        os.makedirs(cut_dir)
        os.chdir(cut_dir)
        HyperReducedPiston._write_snapshot_cache(
            ml.edges, per_cut, False, build_tag, cut_mus, cut_snaps, None)
        with fom_unreachable(hrom.fom):
            rebuilt, rebuild_s = timed(dev, lambda: hrom.build_mulocal_serving(
                dump=False, snapshot_cache=True,
                local_nmdeim=False,
                **dict(kwargs, cell_wn=rebuild_wn, register=None,
                       snapshots_per_cell=per_cut)))
        os.chdir(workdir)
        rom.mulocal = ml
        # The cache holds the standard-clock training trajectories (the
        # registered cells' re-solves are not cached): the rebuild's
        # unregistered cell 1 is the window POD of cell 1's cached
        # trajectories, bit for bit.
        w1, n1 = kwargs["cell_wn"][1]
        prev = rom.windows
        try:
            direct, direct_s = timed(dev, lambda: rom.build_windowed_serving(
                n_windows=w1, num_basis=n1 + kwargs["srom_extra"],
                snapshots=cut_snaps[1]))
        finally:
            rom._set_serving_windows(prev)
        if (rebuilt.cell_wn != rebuild_wn
                or not np.array_equal(rebuilt.cells[1].Vs,
                                      direct.truncate(n1).Vs)):
            raise AssertionError("the cached rebuild differs")
        del direct, cut_snaps
        (auto_wn, floors), auto_s = timed(dev, lambda: hrom.auto_cell_wn(
            [tuple(w) for w in AUTO_WN_CANDIDATES], AUTO_WN_TARGET,
            path=os.path.join(cut_dir, "mulocal_snapshots.npz"),
            expect_n_cells=ml.n_cells, expect_edges=ml.edges))
        print(f"  (f) the resumed directory ({resume_s:.1f} s) served (c)'s "
              f"last batch bit for bit as the building process served it on"
              f" the fleet just built ({info['served_s']:.2f} s, cold); "
              f"from the cache cut to {per_cut} trajectories a "
              f"cell, cell 0 rebuilt at {FLEET_REBUILD_WN[0]}x"
              f"{FLEET_REBUILD_WN[1]} with the FOM "
              f"unreachable in {rebuild_s:.1f} s (cell 1's bases bit for bit"
              f" the window POD of its cached trajectories, {direct_s:.1f} "
              f"s); auto_cell_wn(candidates "
              f"{[f'{w}x{n}' for w, n in AUTO_WN_CANDIDATES]}, target "
              f"{AUTO_WN_TARGET:.0e}) in {auto_s:.1f} s: {auto_wn}, "
              f"predicted floors "
              + ", ".join(f"{f:.2e}" for f in floors) + f" on {power} ok")
        info["persistence"] = dict(built_serve_s=info["served_s"],
                                   resume_s=resume_s,
                                   direct_pod_s=direct_s, auto_s=auto_s,
                                   rebuild_s=rebuild_s,
                                   rebuild_stages=hrom.fleet_seconds,
                                   auto_cell_wn=[list(w) for w in auto_wn],
                                   auto_floors=floors, cache_cut=per_cut)
        info["launches"] = launches
    finally:
        os.chdir(cwd)
    return info


def online_single_phase(mods, dev, power, hrom):
    """Phase 13 of the module doc: the single-μ online path, the vmap
    engine and the evaluation half on phase 11's built ROM (the
    throughput profile, float64 built), every launch counter set to 0
    before the phase and read after (no kernel: the reference computes
    all of it outside Pallas)."""
    import tempfile

    from romtime_tpu_torch.bench import F32_DRIFT_MAX
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
    native = mods["native"]
    with compute_dtype_scope(f64):
        fom.setup()
        fom.update_parametrization(mu_val)
        calls = native.calls["piston_fom_solve"]
        _, fom_s = timed(dev, fom.solve)
        if native.calls["piston_fom_solve"] != calls + 1:
            raise AssertionError("the float64 fom.solve() missed the native "
                                 "loop")
        uh_fom = np.array(fom.solutions.fom)
        with env_scope("ROMTIME_NATIVE_FOM", "0"):
            _, eager_s = timed(dev, fom.solve)
    eager = np.asarray(fom.solutions.fom)
    native_gap = float(np.linalg.norm(uh_fom - eager) / np.linalg.norm(eager))
    print(f"  (b) the float64 FOM: fom.solve() on the native host loop "
          f"{fom_s * 1e3:.1f} ms, the eager loop on the card "
          f"{eager_s * 1e3:.1f} ms ({eager_s / fom_s:.1f}×); native vs "
          f"eager {native_gap:.3e} relative (limit {NATIVE_VS_EAGER:.0e}) "
          f"on {power} {'ok' if native_gap <= NATIVE_VS_EAGER else 'FAIL'}")
    if not native_gap <= NATIVE_VS_EAGER:
        raise AssertionError("the native loop disagrees with the eager loop")
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
    info["native"] = dict(fom_native_s=fom_s, fom_eager_s=eager_s,
                          native_vs_eager=native_gap)

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
    online_native = native.calls["piston_fom_solve"] - calls - 1
    print(f"  evaluate_online's {EVAL_ONLINE} FOM solves on the native "
          f"loop: {online_native} of {EVAL_ONLINE}")
    if online_native != EVAL_ONLINE:
        raise AssertionError("evaluate_online's FOM solves missed the native "
                             "loop")
    info["evaluation"] = dict(validation_s=val_s, online_s=onl_s, rows=rows,
                              files=len(files), native_solves=online_native)
    info["launches"] = [c.launches for c in counters(mods)]
    return info



def heat_golden_fom(dev, power, moving):
    """(a): the MFP1 convergence study's nt=1000 row on the card in
    float64 (nx=500, tf to 99% decay), against the JAX package's value
    and the golden, and the trajectory against the same solve on the
    CPU."""
    from romtime_tpu_torch.convert import heat_fom
    from romtime_tpu_torch.dtypes import compute_dtype_scope

    beta = 5.0
    tf = -np.log(1.0 - 0.99) / beta
    mu = dict(delta=1.0, beta=beta, alpha_0=1.0)
    if moving:
        mu["omega"] = 2.0 * np.pi / (8.0 * tf)
    out = {}
    for device in (dev, "cpu"):
        fom = heat_fom(HEAT_GRID["L"], HEAT_GRID["nx"], tf, HEAT_GRID["nt"],
                       moving=moving, device=device)
        fom.update_parametrization(mu)
        with compute_dtype_scope(torch.float64):
            _, sec = timed(device, fom.solve)
        out[device] = (np.array(fom.solutions.fom), sec,
                       float(np.log10(fom.errors[fom.timesteps[-1]])))
    u, sec, lg = out[dev]
    u_cpu, cpu_s, _ = out["cpu"]
    vs_cpu = float(np.abs(u - u_cpu).max() / np.abs(u_cpu).max())
    vs_ref = abs(lg - HEAT_REF_LOG10[moving])
    golden = abs(lg - HEAT_GOLDEN[moving])
    ref_golden = abs(HEAT_REF_LOG10[moving] - HEAT_GOLDEN[moving])
    ok = (vs_cpu <= CERT_F64_REL and vs_ref <= HEAT_LOG10_ATOL
          and golden <= ref_golden + HEAT_LOG10_ATOL)
    name = "moving" if moving else "fixed"
    print(f"  (a) {name} FOM float64, nx={HEAT_GRID['nx']}, "
          f"nt={HEAT_GRID['nt']}: {sec * 1e3:.1f} ms on the card (CPU "
          f"{cpu_s * 1e3:.1f} ms, trajectories {vs_cpu:.3e} apart, limit "
          f"{CERT_F64_REL:.0e}); log10 error at tf {lg:.9f}: the JAX "
          f"package's {HEAT_REF_LOG10[moving]:.9f} ({vs_ref:.2e}, limit "
          f"{HEAT_LOG10_ATOL:.0e}), the golden {HEAT_GOLDEN[moving]:.9f} "
          f"({golden:.2e}; the JAX package's own gap {ref_golden:.2e}) on "
          f"{power} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the {name} heat FOM missed its golden row")
    return dict(card_ms=sec * 1e3, cpu_ms=cpu_s * 1e3, vs_cpu=vs_cpu,
                log10_error=lg, vs_reference=vs_ref, vs_golden=golden)


def heat_build(dev, moving, workdir):
    """(b): the port builds the fixed or moving heat HROM on ``dev`` in
    float64 (its 4 offline μ in one batched FOM sweep), in ``workdir``;
    returns (hrom, stage seconds)."""
    from romtime_tpu_torch.conventions import Stage
    from romtime_tpu_torch.dtypes import compute_dtype_scope
    from romtime_tpu_torch.rom import (
        HyperReducedOrderModelFixed,
        HyperReducedOrderModelMoving,
    )
    from romtime_tpu_torch.scripts.generate_goldens import heat_config

    cls = HyperReducedOrderModelMoving if moving else HyperReducedOrderModelFixed
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        seconds = {}
        with compute_dtype_scope(torch.float64):
            hrom, seconds["setup"] = timed(dev, lambda: cls(
                **heat_config(HEAT_BUILD_GRID["nx"], HEAT_BUILD_GRID["nt"],
                              moving=moving),
                rnd=np.random.RandomState(0), device=dev))
            for stage, fn in (
                    ("setup", hrom.setup),
                    ("setup_hyperreduction", hrom.setup_hyperreduction),
                    ("offline_rom", lambda: hrom.run_offline_rom(
                        device_sweep=True)),
                    ("hyperreduction", lambda: hrom.run_offline_hyperreduction(
                        mu_space=hrom.mu_space[Stage.OFFLINE],
                        evaluate=False)),
                    ("projection", hrom.project_reductors)):
                _, sec = timed(dev, fn)
                seconds[stage] = seconds.get(stage, 0.0) + sec
    finally:
        os.chdir(cwd)
    return hrom, seconds


def heat_global(mods, dev, power, hrom, name, kernels):
    """(c): B=2048 float32 through K4 (the default budget) and K5 (budget
    0) at ``with_trilinear=False`` and BDF-1, every counter zeroed before
    each branch and read after; each launch on the last batch against its
    twin, the served results against the float32 global lanes engine and
    K5 against K4."""
    import romtime_tpu_torch.rom.engines.global_fused as engine
    import romtime_tpu_torch.rom.engines.windowed_fused as products
    from romtime_tpu_torch.conventions import Stage

    rom = hrom.rom
    batches = [[dict(m) for m in rom.build_sampling_space(
        num=HEAT_B, rnd=np.random.RandomState(40 + c))]
        for c in range(HEAT_CALLS)]
    mus = batches[-1]
    if rom._resolve_engine("probes", HEAT_B) != "pallas":
        raise AssertionError(f"{name}: the heat ROM does not route to the "
                             f"global kernels")
    lanes, lanes_s = timed(dev, lambda: rom.solve_batch(
        mus, step=Stage.ONLINE, mode="probes", engine="lanes"))
    info, served = {"lanes_s": lanes_s}, {}
    for kname, budget in (("K4", None), ("K5", 0)):
        if budget is not None:
            rom.ONLINE_PRECOMPUTE_BUDGET = budget
        try:
            branch = engine.global_branch(HEAT_BUILD_GRID["nt"],
                                          mods["k1"].pad_dim(rom.N), HEAT_B,
                                          rom.precompute_choice)
            if branch != ("matrices" if kname == "K4" else "thetas"):
                raise AssertionError(f"{name}: {kname} routed to {branch}")
            launches, outs, call = serve_global(
                rom, f"heat {name} {kname} (N={rom.N})", batches, mods,
                power, kname)
            out = rom.solve_batch(mus, step=Stage.ONLINE, mode="probes")
            prepped = rom.prep(mus, engine="pallas")
            tables = rom._global_serving_tables()
            (THm, THk, THf, g, b0), kw = engine.window_inputs(
                rom.fom, rom.global_serving, prepped)
            if kw["with_trilinear"] or kw["bdf2"]:
                raise AssertionError(f"{name}: not the no-trilinear BDF-1 "
                                     f"instantiation ({kw})")
            if kname == "K4":
                args = (*engine.window_operators_lanes(
                    tables, 0, THm, THk, THf, 0, HEAT_BUILD_GRID["nt"]), g,
                    tables["T0"][0], tables["VE"][0], b0)
                kw = dict(kw, lane_major=True)
                wrapper = mods["gs"].online_sweep_pallas
                twin = mods["gs"].sweep_reference
                # The bound counts the reference layout's bytes, as the
                # kernel phases do.
                bound_args = (*products.window_operators(
                    tables, 0, THm, THk, THf, 0, HEAT_BUILD_GRID["nt"]),
                    *args[3:])
            else:
                args = (THm, THk, THf, g, tables["Bm"][0], tables["Bk"][0],
                        tables["Bf"][0], tables["T0"][0], tables["VE"][0], b0)
                kw.update(engine.live_rows(tables))
                wrapper = mods["gs"].online_sweep_theta_pallas
                twin = mods["gs"].theta_sweep_reference
                bound_args = args
        finally:
            if budget is not None:
                del rom.ONLINE_PRECOMPUTE_BUDGET
        ms, got = cuda_ms(lambda: wrapper(*args, **kw), GLOBAL_REPS)
        plain_ms, want = cuda_ms(lambda: twin(*args, **kw), 1, warmup=False)
        err = check_global(f"  heat {name} {kname} launch vs its twin "
                           f"(B={HEAT_B}, N={rom.N}):", got, want)
        bms, by = GLOBAL_BOUND[kname](bound_args, kw)
        served[kname] = out
        row = kernels.setdefault(kname, dict(max_abs_err=0.0))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         N=rom.N, launches=launches[KERNELS.index(kname)],
                         **call)
        print(f"  heat {name} {kname}: {ms:.3f} ms a sweep, twin "
              f"{plain_ms:.1f} ms, bound {bms:.4f} ms ({by}); served "
              f"{call['solves_per_s']:.1f} solves/s on {power}")
        del args, got, want, prepped, bound_args
    scale = np.abs(lanes["probes"]).max()
    uscale = max(np.abs(lanes["uN_final"]).max(), 1.0)
    gaps = {}
    for kname, out in served.items():
        gaps[kname] = (float(np.abs(out["probes"] - lanes["probes"]).max()),
                       float(np.abs(out["uN_final"]
                                    - lanes["uN_final"]).max()))
    k5k4 = (float(np.abs(served["K5"]["probes"]
                         - served["K4"]["probes"]).max()),
            float(np.abs(served["K5"]["uN_final"]
                         - served["K4"]["uN_final"]).max()))
    k4scale = max(np.abs(served["K4"]["uN_final"]).max(), 1.0)
    ok = (all(p <= GLOBAL_PROBES_REL * scale and u <= GLOBAL_UN_REL * uscale
              for p, u in gaps.values())
          and k5k4[0] <= THETA_VS_TABLES_REL * scale
          and k5k4[1] <= THETA_VS_TABLES_REL * k4scale)
    print(f"  heat {name} served vs the float32 global lanes engine "
          f"({lanes_s * 1e3:.1f} ms): "
          + ", ".join(f"{k} probes {p:.3e} uN {u:.3e}"
                      for k, (p, u) in gaps.items())
          + f" (limits {GLOBAL_PROBES_REL * scale:.3e}, "
          f"{GLOBAL_UN_REL * uscale:.3e}); K5 vs K4 {k5k4[0]:.3e} / "
          f"{k5k4[1]:.3e} (limit {THETA_VS_TABLES_REL:.0e}·scale) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"heat {name}: the served results disagree")
    info.update(vs_lanes=gaps, k5_vs_k4=k5k4)
    return info


def heat_windowed(mods, dev, power, hrom, kernels):
    """(d): the fixed heat ROM's windows (4 of N=8) served at B=2048
    through K1 (budget 0: the fused branch) against the float32 windowed
    lanes engine, the launch against its twin; the float64
    ``engine="windowed"`` against the FOM."""
    import romtime_tpu_torch.rom.engines.windowed_fused as wengine
    from romtime_tpu_torch.conventions import Stage
    from romtime_tpu_torch.dtypes import compute_dtype_scope

    rom = hrom.rom
    W, N = HEAT_WINDOWS
    _, build_s = timed(dev, lambda: hrom.build_windowed_serving(
        n_windows=W, num_basis=N, dump=False))
    if rom.windows.trilinear is not None:
        raise AssertionError("the heat windows carry a trilinear table")
    mus = [dict(m) for m in rom.build_sampling_space(
        num=HEAT_B, rnd=np.random.RandomState(50))]
    rom.ONLINE_PRECOMPUTE_BUDGET = 0
    try:
        k1 = mods["k1"].online_sweep_windowed_fused
        rom.solve_batch(mus, mode="probes")
        for c in counters(mods):
            c.launches = c.serving_launches = c.first_design_launches = 0
        out, serve_s = timed(dev, lambda: rom.solve_batch(
            mus, step=Stage.ONLINE, mode="probes"))
        launches = [c.launches for c in counters(mods)]
        if launches != [1, 0, 0, 0, 0] or k1.serving_launches != 1:
            raise AssertionError(f"heat windowed: launches {launches}")
        prepped = rom.prep(mus)
        args, kw = wengine.sweep_inputs(rom.fom, rom.windows, prepped,
                                        rom._windowed_tables(),
                                        rom.windowed_solve())
    finally:
        del rom.ONLINE_PRECOMPUTE_BUDGET
    if kw["with_trilinear"] or kw["bdf2"]:
        raise AssertionError(f"heat windowed: not the no-trilinear BDF-1 "
                             f"instantiation ({kw})")
    ms, got = cuda_ms(lambda: k1(*args, **kw), KERNEL_REPS)
    plain_ms, want = cuda_ms(
        lambda: mods["k1"].windowed_fused_reference(*args, **kw), 1,
        warmup=False)
    err = check_sweep(f"  heat windowed K1 launch vs its twin (B={HEAT_B}, "
                      f"W={W}, N={N}):", got, want)
    bms, by = k1_bound(args, kw)
    lanes, lanes_s = timed(dev, lambda: rom.solve_batch(
        mus, step=Stage.ONLINE, mode="probes", engine="windowed"))
    scale = max(np.abs(lanes["probes"]).max(), 1e-3)
    p_gap = float(np.abs(out["probes"] - lanes["probes"]).max())
    u_gap = float(np.abs(out["uN_final"] - lanes["uN_final"]).max())
    mu_val = dict(delta=0.9, beta=4.5, alpha_0=1.1)
    fom = hrom.fom
    fom.setup()
    fom.update_parametrization(mu_val)
    with compute_dtype_scope(torch.float64):
        fom.solve()
        full, f64_s = timed(dev, lambda: rom.solve_batch(
            [mu_val], step=Stage.VALIDATION, mode="full", engine="windowed"))
    uh = np.asarray(fom.solutions.fom)
    fom_rel = float(np.linalg.norm(full["uc"][0].T - uh) / np.linalg.norm(uh))
    ok = (p_gap <= WINDOWED_PROBES_REL * scale and u_gap <= WINDOWED_UN_ATOL
          and fom_rel <= HEAT_WINDOWED_FOM_REL)
    print(f"  (d) heat windowed serving ({W} windows of N={N}, built in "
          f"{build_s:.2f} s): one K1 launch, {serve_s * 1e3:.1f} ms a call "
          f"= {HEAT_B / serve_s:.1f} solves/s; K1 {ms:.3f} ms, twin "
          f"{plain_ms:.1f} ms, bound {bms:.4f} ms ({by}); vs the float32 "
          f"windowed lanes engine ({lanes_s * 1e3:.1f} ms) probes "
          f"{p_gap:.3e} (limit {WINDOWED_PROBES_REL * scale:.3e}), uN "
          f"{u_gap:.3e} (limit {WINDOWED_UN_ATOL:.0e}); float64 "
          f"engine='windowed' vs the FOM {fom_rel:.3e} (limit "
          f"{HEAT_WINDOWED_FOM_REL:.0e}) on {power} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("heat windowed serving disagrees")
    row = kernels.setdefault("K1", dict(max_abs_err=0.0))
    row["max_abs_err"] = max(row["max_abs_err"], err)
    row["windowed"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                           bound_by=by, W=W, N=N, launches=launches[0],
                           serve_ms=serve_s * 1e3)
    return dict(build_s=build_s, serve_ms=serve_s * 1e3, vs_lanes=(p_gap,
                u_gap), vs_fom=fom_rel, f64_full_s=f64_s)


def heat_certify(dev, power, hrom, name):
    """(e): ``estimate_batch`` in float64 at B=16 on the card against the
    same ROM pair carried to the CPU, by tests/test_hrom.py:442-520's
    contract."""
    from romtime_tpu_torch.convert import (
        global_serving_from_arrays,
        global_serving_to_arrays,
    )
    from romtime_tpu_torch.dtypes import compute_dtype_scope

    which = "mfp1-moving" if name == "moving" else "mfp1"
    rom_cpu, srom_cpu = (global_serving_from_arrays(
        global_serving_to_arrays(r, which=which), device="cpu")
        for r in (hrom.rom, hrom.srom))
    cpu = type(hrom).from_serving(rom_cpu, srom=srom_cpu)
    mus = [dict(m) for m in hrom.rom.build_sampling_space(
        num=HEAT_SMALL_B, rnd=np.random.RandomState(60))]
    with compute_dtype_scope(torch.float64):
        out, card_s = timed(dev, lambda: hrom.estimate_batch(mus))
        ref, cpu_s = timed("cpu", lambda: cpu.estimate_batch(mus))
    gaps = [max_gap(out[k]["uN"], ref[k]["uN"]) for k in ("rom", "srom")]
    sweep_gap = max(g / s for g, s in gaps)
    formula, slack, avg = estimator_contract(
        out, ref, np.asarray(hrom.srom.basis), HEAT_BUILD_GRID["nt"])
    ok = sweep_gap <= CERT_F64_REL
    print(f"  (e) heat {name} estimate_batch float64, B={HEAT_SMALL_B}: card "
          f"{card_s:.2f} s, CPU {cpu_s:.2f} s; the sweeps {sweep_gap:.3e} "
          f"apart (limit {CERT_F64_REL:.0e}·scale); the estimator the "
          f"formula within {formula:.2e}, the triangle bound's slack "
          f"{slack:.2e}, averages {avg[0]:.3e}..{avg[1]:.3e} on {power} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"heat {name}: the card's certification "
                             f"disagrees with the CPU")
    return dict(card_s=card_s, cpu_s=cpu_s, sweep_gap=sweep_gap,
                formula_gap=formula, bound_slack=slack)


def heat_phase(mods, dev, power):
    """Phase 14 of the module doc: the MFP1 heat family, fixed and moving,
    at nx=500, nt=1000, every launch counter zeroed before each served
    run and read after."""
    import tempfile

    info = {"card": power, "grid": HEAT_GRID, "build_grid": HEAT_BUILD_GRID}
    kernels = {}
    print(f"heat phase: MFP1 at nx={HEAT_GRID['nx']}, nt={HEAT_GRID['nt']}"
          f" (the HROMs at nx={HEAT_BUILD_GRID['nx']}, "
          f"nt={HEAT_BUILD_GRID['nt']})")
    for moving in (False, True):
        name = "moving" if moving else "fixed"
        part = info[name] = {"fom": heat_golden_fom(dev, power, moving)}
        with tempfile.TemporaryDirectory() as workdir:
            hrom, seconds = heat_build(dev, moving, workdir)
            print(f"  (b) heat {name} HROM built on the card: ROM N="
                  f"{hrom.rom.N}, S-ROM N={hrom.srom.N}; "
                  + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items()))
            part["build"] = dict(seconds=seconds, N=hrom.rom.N,
                                 N_srom=hrom.srom.N)
            part["global"] = heat_global(mods, dev, power, hrom, name,
                                         kernels)
            if not moving:
                part["windowed"] = heat_windowed(mods, dev, power, hrom,
                                                 kernels)
            part["certify"] = heat_certify(dev, power, hrom, name)
        del hrom
        torch.cuda.empty_cache()
    info["kernels"] = kernels
    info["launches"] = {k: sum(v.get(n, {}).get("launches", 0)
                               for n in ("fixed", "moving", "windowed"))
                        for k, v in kernels.items()}
    return info


def sine_largest_angle(Q, P):
    """Sine of the largest principal angle between the spans of the
    orthonormal columns of Q and of P."""
    return float(np.linalg.norm(Q - P @ (P.T @ Q), 2))


def spy_devices(obj, name, seen):
    """Wrap ``obj.name`` (a method taking a μ batch first) to record the
    device of each call's μ."""
    real = getattr(obj, name)

    def spy(mu, *args, **kwargs):
        seen.append(str(next(iter(mu.values())).device))
        return real(mu, *args, **kwargs)

    setattr(obj, name, spy)


def multi_device_phase(mods, dev, power, batch, fom_seconds):
    """Phase 15 of the module doc: the sharded sweeps, TSQR and the dry
    run over a mesh of two shards on the card and, in (e), over a mesh of
    the card and the CPU, every launch counter set to 0 before the phase
    and read after (none: the reference's sharded paths reach no
    Pallas kernel). ``batch``: phase 10's float32 one-batch outputs of
    the first MD_FOM_B μ, ``fom_seconds`` that sweep's seconds."""
    from romtime_tpu_torch.convert import piston_fom
    from romtime_tpu_torch.dtypes import compute_dtype_scope
    from romtime_tpu_torch.parallel import (
        DeviceMesh,
        device_mesh,
        dryrun,
        orth_distributed,
        solve_fom_batch,
        solve_fom_sharded,
        solve_online_sharded,
        solve_online_windowed_sharded,
    )
    from romtime_tpu_torch.rom import RomConstructorNonlinear
    from romtime_tpu_torch.rom.pod import orth

    synth = mods["synth"]
    card0, cpu = torch.device(dev), torch.device("cpu")
    two = DeviceMesh([card0, card0])
    f64 = torch.float64
    info = {"card": power, "mesh": str(two)}
    for c in counters(mods):
        c.launches = c.serving_launches = c.first_design_launches = 0

    # (a) The sharded FOM sweep at the flagship width against phase 10's
    # one batch on the same μ (its first MD_FOM_B rows), float32 on the
    # card.
    fom = piston_fom(**FOM_GRID, device=dev)
    mus = fom_mus()[:MD_FOM_B]
    sharded, sharded_s = timed(dev, lambda: solve_fom_sharded(fom, mus,
                                                              mesh=two))
    gaps = {}
    for key in sorted(batch):
        if sharded[key].shape != batch[key].shape:
            raise AssertionError(f"(a) {key}: {sharded[key].shape} vs "
                                 f"{batch[key].shape}")
        gaps[key] = float(per_mu_rel(sharded[key], batch[key]).max())
    worst = max(gaps.values())
    print(f"  (a) solve_fom_sharded at nx={FOM_GRID['nx']}, "
          f"nt={FOM_GRID['nt']}, B={MD_FOM_B} on {two}: {sharded_s:.2f} s "
          f"(phase 10's one batch of {FOM_B}: {fom_seconds:.2f} s); worst "
          f"per-μ relative gap to its rows {worst:.3e} (limit "
          f"{MD_FOM_REL:.0e}) on {power}")
    if worst > MD_FOM_REL:
        raise AssertionError(f"(a) sharded FOM sweep disagrees: {gaps}")
    info["fom"] = dict(B=MD_FOM_B, seconds=sharded_s,
                       batch_seconds=fom_seconds, batch_B=FOM_B,
                       rel_gaps=gaps)

    # (b) TSQR POD of (a)'s snapshots, float64 on the card, against the
    # host SVD of the same matrix.
    nh = sharded["uh"].shape[-1]
    S = sharded["uh"].reshape(-1, nh).T.astype(np.float64)
    del sharded
    (Q, s, _e), tsqr_s = timed(dev, lambda: orth_distributed(S, mesh=two))
    t0 = time.perf_counter()
    Q_h, s_h, _e_h = orth(S)
    host_s = time.perf_counter() - t0
    sig = float(np.abs(s[:len(s_h)] - s_h).max() / s_h[0])
    k = MD_MODES
    sine = sine_largest_angle(Q[:, :k], Q_h[:, :k])
    gap_k = float((s_h[k - 1] - s_h[k]) / s_h[0])
    print(f"  (b) orth_distributed of the {S.shape} snapshot matrix: "
          f"{tsqr_s:.2f} s on {two}, host orth {host_s:.2f} s; σ gap "
          f"{sig:.3e} of σ₁ (limit {MD_SIGMA_REL:.0e}), retained "
          f"{Q.shape[1]} / {Q_h.shape[1]} modes, sine of the largest angle "
          f"of the first {k} spans {sine:.3e} (limit {MD_SINE:.0e}; "
          f"(σ_{k} − σ_{k + 1})/σ₁ = {gap_k:.3e}) on {power}")
    if sig > MD_SIGMA_REL or sine > MD_SINE or Q.shape != Q_h.shape:
        raise AssertionError("(b) TSQR disagrees with the host SVD")
    info["tsqr"] = dict(shape=list(S.shape), seconds=tsqr_s,
                        host_seconds=host_s, sigma_rel=sig, sine=sine,
                        modes=Q.shape[1], gap=gap_k)
    del S, Q, Q_h

    # The synthetic fleet at phase 9's time grid: (c) on its 50x32 cell 0,
    # (d) routed over cells 0 and 5.
    fleet = synth.synthetic_fleet(device=dev, **CERT_FLEET_GRID)
    ml = fleet.mulocal

    # (c) The sharded windowed lanes engine against the single-device
    # engine on one cell, float64.
    wmus = synth.synthetic_mus(MD_WINDOWED_B, seed=15)
    prev = fleet.windows
    fleet._set_serving_windows(ml.cells[0])
    with compute_dtype_scope(f64):
        single, single_s = timed(dev, lambda: fleet.solve_batch(
            wmus, mode="probes", engine="windowed"))
        wsh, wsh_s = timed(dev, lambda: solve_online_windowed_sharded(
            fleet, wmus, mesh=two, mode="probes"))
    fleet._set_serving_windows(prev)
    wgaps = {}
    for key in ("probes", "uN_final"):
        scale = max(np.abs(single[key]).max(), 1e-3)
        wgaps[key] = float(np.abs(wsh[key] - single[key]).max() / scale)
    print(f"  (c) solve_online_windowed_sharded, 50x32 cell (nt="
          f"{CERT_FLEET_GRID['nt']}), B={MD_WINDOWED_B}, float64: "
          f"{wsh_s:.2f} s against one device {single_s:.2f} s; gaps of "
          f"scale {wgaps} (limit {MD_LANES_REL:.0e}) on {power}")
    if max(wgaps.values()) > MD_LANES_REL:
        raise AssertionError("(c) sharded windowed sweep disagrees")
    info["windowed"] = dict(B=MD_WINDOWED_B, seconds=wsh_s,
                            single_seconds=single_s, gaps=wgaps)

    # (d) Routed and sharded: each cell's rows against its direct
    # single-device rows.
    pool = synth.synthetic_mus(256, seed=16)
    cells = ml.cell_of([RomConstructorNonlinear.compute_piston_mach_number(m)
                        for m in pool])
    dmus = [pool[i] for c in MD_ROUTED_CELLS
            for i in np.nonzero(np.asarray(cells) == c)[0][:2]]
    dcells = [c for c in MD_ROUTED_CELLS for _ in range(2)]
    with compute_dtype_scope(f64):
        routed, routed_s = timed(dev, lambda: fleet.solve_batch_mulocal(
            [dict(m) for m in dmus], sweep_fn=lambda sub: (
                solve_online_windowed_sharded(fleet, sub, mesh=two,
                                              mode="probes"))))
        dgaps = {}
        for c in MD_ROUTED_CELLS:
            idx = [i for i, cc in enumerate(dcells) if cc == c]
            sub = [dict(dmus[i]) for i in idx] * 2
            fleet._set_serving_windows(ml.cells[c])
            direct = fleet.solve_batch(sub, mode="probes", engine="windowed")
            for key in ("probes", "uN_final", "dil"):
                if key not in direct:
                    continue
                scale = max(np.abs(direct[key]).max(), 1e-3)
                dgaps[f"{c}/{key}"] = max(
                    float(np.abs(np.asarray(routed[key][i])
                                 - direct[key][j]).max() / scale)
                    for j, i in enumerate(idx))
        fleet._set_serving_windows(prev)
    print(f"  (d) routed + sharded on cells {MD_ROUTED_CELLS} (nt="
          f"{CERT_FLEET_GRID['nt']}), 2 μ each: {routed_s:.2f} s; gaps to "
          f"the direct rows of scale {dgaps} (limit {MD_ROUTED_REL:.0e}) "
          f"on {power}")
    if max(dgaps.values()) > MD_ROUTED_REL or "5/dil" not in dgaps:
        raise AssertionError("(d) routed sharded rows disagree")
    info["routed"] = dict(seconds=routed_s, gaps=dgaps)
    del fleet, ml

    # (e) A mixed mesh, the card and the CPU, at tests/test_parallel.py's
    # size in float64: each shard where the mesh says.
    mixed = DeviceMesh([card0, cpu])
    tiny = piston_fom(**MD_TINY, device="cpu")
    tmus = synth.synthetic_mus(8, seed=17)
    rng = np.random.default_rng(0)
    V = np.linalg.qr(rng.normal(size=(tiny.mesh.nh, 4)))[0]
    trom = RomConstructorNonlinear(fom=tiny, grid=None, device="cpu")
    trom.setup(rnd=0)
    trom.basis = V
    seen = {"fom": [], "online": []}
    with compute_dtype_scope(f64):
        one_fom = solve_fom_batch(tiny, tmus)
        one_rom = solve_online_sharded(trom, tmus, mesh=DeviceMesh([cpu]))
        spy_devices(tiny, "_solve_impl", seen["fom"])
        spy_devices(trom, "_online_scan", seen["online"])
        (mix_fom, mix_rom), mixed_s = timed(dev, lambda: (
            solve_fom_sharded(tiny, tmus, mesh=mixed),
            solve_online_sharded(trom, tmus, mesh=mixed)))
    egaps = {}
    for label, got, want in (("fom", mix_fom, one_fom),
                             ("online", mix_rom, one_rom)):
        for key in sorted(want):
            scale = max(np.abs(want[key]).max(), 1e-30)
            egaps[f"{label}/{key}"] = float(
                np.abs(got[key] - want[key]).max() / scale)
    print(f"  (e) mixed mesh {mixed}, nx={MD_TINY['nx']}, nt="
          f"{MD_TINY['nt']}, float64: {mixed_s:.2f} s; shards ran on "
          f"{seen}; worst gap to one device "
          f"{max(egaps.values()):.3e} of scale (limit {MD_MIXED_REL:.0e}) "
          f"on {power}")
    want_where = [str(torch.empty(0, device=card0).device), "cpu"]
    if (seen["fom"] != want_where or seen["online"] != want_where
            or max(egaps.values()) > MD_MIXED_REL):
        raise AssertionError(f"(e) mixed mesh: {seen}, {egaps}")
    info["mixed"] = dict(seconds=mixed_s, devices=seen, gaps=egaps)

    # (f) The dry run on the two-shard mesh and on every card, the
    # serving HROM built on the card once.
    hrom, build_s = timed(dev, lambda: dryrun.serving_hrom(dev))
    runs = {}
    for label, mesh in (("two_shards", two), ("device_mesh", device_mesh(device_type=card0.type))):
        (value, served), secs = timed(
            dev, lambda: dryrun.dryrun_multichip(mesh, rom=hrom.rom))
        if not (np.isfinite(value) and np.isfinite(served)):
            raise AssertionError(f"(f) {label}: not finite")
        runs[label] = dict(mesh=str(mesh), seconds=secs, diagnostic=value,
                           serving=served)
    print(f"  (f) dry run: serving HROM built in {build_s:.2f} s; "
          + "; ".join(f"{k} {v['mesh']} {v['seconds']:.2f} s, diagnostic "
                      f"{v['diagnostic']:.6e}, serving {v['serving']:.6e}"
                      for k, v in runs.items()) + f" on {power}")
    info["dryrun"] = dict(build_seconds=build_s, runs=runs)

    info["launches"] = [c.launches for c in counters(mods)]
    return info


def launch_counts(mods):
    """The launch counters of K1-K5 now, as a list."""
    return [c.launches for c in counters(mods)]


def launches_since(mods, before):
    """Launches of K1-K5 since ``before`` (:func:`launch_counts`)."""
    return [c - b for c, b in zip(launch_counts(mods), before)]


def example_poisson(dev, power):
    """(a): the Poisson tutorial's certification grids and POD family on
    the card against the same functions on the CPU."""
    from romtime_tpu_torch.examples import poisson_tutorial as pt

    (card, pod), sec = timed(dev, lambda: (pt.certify(dev),
                                           pt.pod_family(dev)))
    cpu, pod_cpu = pt.certify("cpu"), pt.pod_family("cpu")
    u_gap = err_gap = 0.0
    for nx, (u, err) in card.items():
        u_cpu, err_cpu = cpu[nx]
        scale = np.abs(u_cpu).max()
        u_gap = max(u_gap, float(np.abs(u - u_cpu).max() / scale))
        err_gap = max(err_gap, abs(err - err_cpu) / scale)
    sign = np.sign(pod["basis"][:, 0] @ pod_cpu["basis"][:, 0])
    basis_gap = float(np.abs(pod["basis"] - sign * pod_cpu["basis"]).max())
    rec = max(pod["reconstruction_rel"], pod_cpu["reconstruction_rel"])
    ok = (u_gap <= EX_EXACT_REL and err_gap <= EX_EXACT_REL
          and pod["basis"].shape == pod_cpu["basis"].shape
          and pod["basis"].shape[1] == 1 and basis_gap <= EX_EXACT_REL
          and rec <= EX_EXACT_REL)
    print(f"  (a) poisson_tutorial: nx {list(card)} L2 errors "
          + ", ".join(f"{card[nx][1]:.3e}" for nx in card)
          + f" (the CPU's within {err_gap:.2e} of the solution's scale), "
          f"solutions within {u_gap:.2e} relative of the CPU's; POD "
          f"{pod['basis'].shape[1]} mode(s), basis within {basis_gap:.2e}, "
          f"unseen-α reconstruction {pod['reconstruction_rel']:.2e} "
          f"(limits {EX_EXACT_REL:.0e}); {sec:.2f} s on {power} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("poisson_tutorial: the card and the CPU differ")
    return dict(seconds=sec, errors={nx: e for nx, (_u, e) in card.items()},
                u_rel_gap=u_gap, error_gap=err_gap, modes=1,
                basis_gap=basis_gap,
                reconstruction_rel=pod["reconstruction_rel"])


def example_heat_2d(dev, power):
    """(b): the 2-D heat example at nx 16 and 32 (nt=50) on the card
    against the CPU: the error series within 1e-12 of the field's scale,
    the final field within 1e-12 relative."""
    from romtime_tpu_torch.examples.heat_2d import solve_heat_2d

    rows = {}
    for nx in EX_HEAT2D_NX:
        (_ts, errs, u), sec = timed(dev, lambda: solve_heat_2d(nx=nx, nt=50,
                                                               device=dev))
        _ts, errs_cpu, u_cpu = solve_heat_2d(nx=nx, nt=50, device="cpu")
        scale = np.abs(u_cpu).max()
        u_gap = float(np.abs(u - u_cpu).max() / scale)
        e_gap = float(np.abs(errs - errs_cpu).max() / scale)
        ok = u_gap <= EX_EXACT_REL and e_gap <= EX_EXACT_REL
        print(f"  (b) heat_2d nx={nx}: max|u - u_e| at tf {errs[-1]:.3e} "
              f"(over the run {errs.max():.3e}), error series within "
              f"{e_gap:.2e} of the field's scale and the field within "
              f"{u_gap:.2e} relative of the CPU's (limit "
              f"{EX_EXACT_REL:.0e}); {sec:.2f} s on {power} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"heat_2d nx={nx}: the card and the CPU "
                                 f"differ")
        rows[nx] = dict(seconds=sec, error_tf=float(errs[-1]),
                        error_max=float(errs.max()), u_rel_gap=u_gap,
                        error_gap=e_gap)
    return rows


def example_piston(mods, dev, power):
    """(c): the piston walkthrough at its defaults on the card: the build,
    the served probes through K4 or K5 (B=128, one 128-lane block) held
    against the float64 global lanes engine, the estimator; then the
    ``--windowed`` configuration (two Mach cells), its routed rows ≡ each
    cell's direct rows, its per-cell estimator."""
    import tempfile

    from romtime_tpu_torch.conventions import Errors
    from romtime_tpu_torch.dtypes import compute_dtype_scope
    from romtime_tpu_torch.examples import piston_rom as pr

    info = {}
    with tempfile.TemporaryDirectory() as workdir:
        (hrom, build_s), sec = timed(dev, lambda: pr.build_pipeline(
            workdir, device=dev, **EX_PISTON_GRID))
        rom = hrom.rom
        print(f"  (c) piston_rom build (nx={EX_PISTON_GRID['nx']}, nt="
              f"{EX_PISTON_GRID['nt']}, float64): {build_s:.1f} s, ROM "
              f"N={rom.N}, S-ROM N={hrom.srom.N} on {power}")
        drawn = pr.serving_mus(rom, EX_PISTON_B)
        mus = (drawn * -(-EX_PISTON_B // len(drawn)))[:EX_PISTON_B]
        before = launch_counts(mods)
        served, serve_s = pr.serve(rom, mus)
        launches = launches_since(mods, before)
        if launches[:3] != [0, 0, 0] or launches[3] + launches[4] != 2:
            raise AssertionError(f"the example's two served calls launched "
                                 f"{launches}, expected K4 or K5 twice")
        with compute_dtype_scope(torch.float64):
            lanes, lanes_s = timed(dev, lambda: rom.solve_batch(
                mus, mode="probes", engine="lanes"))
        perr = float(np.abs(served["probes"] - lanes["probes"]).max())
        pscale = float(np.abs(lanes["probes"]).max())
        uerr = float(np.abs(served["uN_final"] - lanes["uN_final"]).max())
        uscale = max(float(np.abs(lanes["uN_final"]).max()), 1.0)
        ok = perr <= CERT_PROBES_REL * pscale and uerr <= CERT_UN_REL * uscale
        print(f"  (c) served B={EX_PISTON_B} ({len(drawn)} distinct μ "
              f"cycled) through {'K4' if launches[3] else 'K5'}: "
              f"{serve_s * 1e3:.1f} ms a call = "
              f"{EX_PISTON_B / serve_s:.1f} solves/s, launches K1-K5 "
              f"{launches}; against the float64 global lanes engine "
              f"({lanes_s:.2f} s): probes {perr:.3e} (limit "
              f"{CERT_PROBES_REL * pscale:.3e}), uN_final {uerr:.3e} (limit "
              f"{CERT_UN_REL * uscale:.3e}) on {power} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("the example's served probes miss the "
                                 "float64 lanes engine")
        cert_mus = drawn[:EX_CERT_B]
        est, est_s = timed(dev, lambda: pr.certify(hrom, cert_mus))
        avg = np.asarray(est[Errors.AVERAGE_ESTIMATOR])
        e = np.asarray(est[Errors.ESTIMATOR])
        if (e.shape[0] != len(cert_mus) or not np.isfinite(e).all()
                or (avg < 0).any()):
            raise AssertionError("the example's estimator is not finite "
                                 "and ≥ 0")
        print(f"  (c) certification B={len(cert_mus)}, float64: {est_s:.2f} "
              f"s; median {np.median(avg):.2e}, worst {avg.max():.2e} on "
              f"{power} ok")
        info.update(build_s=build_s, build_phase_s=sec,
                    build_stages=dict(hrom.build_seconds), N=rom.N,
                    N_srom=hrom.srom.N, B=EX_PISTON_B,
                    distinct_mus=len(drawn), serve_ms=serve_s * 1e3,
                    solves_per_s=EX_PISTON_B / serve_s, launches=launches,
                    kernel="K4" if launches[3] else "K5",
                    probes_err=perr, probes_scale=pscale, uN_err=uerr,
                    lanes_s=lanes_s, estimator_s=est_s,
                    estimator_median=float(np.median(avg)),
                    estimator_worst=float(avg.max()))

        # --windowed: the windows, two Mach cells, routed serving through
        # the windowed lanes engine, the per-cell estimator.
        with pr.working_directory(workdir):
            (ml, fleet_s), sec = timed(dev, lambda: pr.build_windowed_fleet(
                hrom))
        fmus = pr.serving_mus(rom, 16)
        before = launch_counts(mods)
        out, fserve_s = timed(dev, lambda: pr.serve_fleet(rom, fmus))
        cells = ml.cell_of([rom.compute_piston_mach_number(m) for m in fmus])
        worst = routed_rows_equal_direct(rom, ml, out, fmus, cells, len(fmus),
                                         engine="windowed")
        fest, fest_s = timed(dev, lambda: pr.certify(hrom, fmus,
                                                     mulocal=True))
        flaunch = launches_since(mods, before)
        favg = np.asarray(fest[Errors.AVERAGE_ESTIMATOR])
        if not np.isfinite(favg).all() or (favg <= 0).any() or any(flaunch):
            raise AssertionError(f"--windowed: estimator not finite and > 0 "
                                 f"or a kernel launched ({flaunch})")
        print(f"  (c) --windowed: windows and two cells built in "
              f"{sec:.1f} s (the cells {fleet_s:.1f}); {len(fmus)} μ routed "
              f"(occupancy {np.bincount(cells, minlength=2).tolist()}) "
              f"through the windowed lanes engine in {fserve_s:.2f} s, "
              f"routed ≡ direct (max abs diff {worst}); per-cell estimator "
              f"{fest_s:.2f} s, median {np.median(favg):.2e}, worst "
              f"{favg.max():.2e}; launches K1-K5 {flaunch} on {power} ok")
        info["windowed"] = dict(build_s=sec, cells_s=fleet_s, B=len(fmus),
                                serve_s=fserve_s,
                                routed_vs_direct_max_abs=worst,
                                estimator_s=fest_s,
                                estimator_median=float(np.median(favg)),
                                estimator_worst=float(favg.max()))
    return info


def example_convergence(dev, power):
    """(d): the MFP1 convergence study at the goldens' size on the card,
    fixed and moving; the nt=1000 rows against the JAX package's values."""
    from romtime_tpu_torch.scripts import mpf1_convergence as mc

    tf = -np.log(1.0 - 0.99) / 5.0
    out = {}
    for moving in (False, True):
        rows, sec = timed(dev, lambda: mc.convergence_rows(
            EX_HEAT_NTS, nx=HEAT_GRID["nx"], tf=tf, L=HEAT_GRID["L"],
            moving=moving, device=dev))
        last = rows[-1]
        gap = abs(last["log10_error"] - HEAT_REF_LOG10[moving])
        ok = last["nt"] == HEAT_GRID["nt"] and gap <= HEAT_LOG10_ATOL
        name = "moving" if moving else "fixed"
        print(f"  (d) mpf1_convergence {name}, nx={HEAT_GRID['nx']}, nts "
              f"{list(EX_HEAT_NTS)}: log10 errors "
              + ", ".join(f"{r['log10_error']:.9f}" for r in rows)
              + f"; rates {np.round(mc.observed_rates(rows), 4).tolist()}; "
              f"nt={last['nt']} within {gap:.2e} of the JAX package's "
              f"{HEAT_REF_LOG10[moving]:.9f} (limit {HEAT_LOG10_ATOL:.0e}); "
              f"{sec:.2f} s on {power} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"mpf1_convergence {name} missed the JAX "
                                 f"package's nt=1000 row")
        out[name] = dict(seconds=sec, rows=rows, vs_reference=gap)
    return out


def example_diagnostics(mods, dev, power, fleet_dir):
    """(e): the diagnostic scripts, warm, on phase 12's fleet directory:
    permu_diag and multimu_diag on EX_DIAG_HELD_OUT held-out μ and the
    center (the center alone at 0), corner_attrib, window_study (a
    floor, then a served point
    with its float32 drift), and on cell 0's real tables K1's phase
    clocks (the ablation ledger runs in (g), the entry's) and each ledger
    variant against its twin."""
    import argparse

    from romtime_tpu_torch.problems import joint_profile
    from romtime_tpu_torch.scripts import (
        corner_attrib,
        kernel_ledger,
        multimu_diag,
        permu_diag,
        window_study,
    )

    info = {}
    hrom, resume_s = timed(dev, lambda: permu_diag.build_hrom(
        fleet_dir, joint_profile(device=dev, **FLEET_BUILD_GRID), dev))
    rom = hrom.rom
    cache = os.path.join(fleet_dir, permu_diag.FOM_CACHE)
    mus = ((permu_diag.validation_mus(rom, EX_DIAG_HELD_OUT)
            if EX_DIAG_HELD_OUT else []) + [dict(multimu_diag.CENTER_MU)])
    rows, permu_s = timed(dev, lambda: permu_diag.per_mu_rows(hrom, mus,
                                                              cache))
    split, multi_s = timed(dev, lambda: multimu_diag.diagnose(
        hrom, mus, rom.mulocal, cache))
    worst_same = worst_sum = 0.0
    for r, s in zip(rows, split):
        worst_same = max(worst_same, abs(s["rel"] - r["rel"]) / r["rel"])
        worst_sum = max(worst_sum, abs(s["rel"] ** 2 - s["floor"] ** 2
                                       - s["inspace"] ** 2) / s["rel"] ** 2)
    ok = (worst_same <= EX_EXACT_REL and worst_sum <= EX_EXACT_REL
          and all(np.isfinite(r["ratio"]) for r in rows))
    print(f"  (e) resumed phase 12's fleet in {resume_s:.1f} s; permu_diag "
          f"({permu_s:.1f} s) and multimu_diag ({multi_s:.1f} s) on "
          + (f"{EX_DIAG_HELD_OUT} held-out μ and " if EX_DIAG_HELD_OUT
             else "") + "the center (the scripts' own: 16 held-out μ; "
          "phase 12 (d) certifies bench's 15 on this fleet): "
          + "; ".join(f"Mach {r['mach']:.4f} cell {r['cell']} d "
                      f"{r['dil']:.5f} rel-L2 {r['rel']:.3e} est/true "
                      f"{r['ratio']:.2f} floor {s['floor']:.3e} in-span "
                      f"{s['inspace']:.3e}" for r, s in zip(rows, split))
          + f"; the two scripts' rel-L2 within {worst_same:.1e} relative, "
          f"rel² = floor² + in-span² within {worst_sum:.1e} (limits "
          f"{EX_EXACT_REL:.0e}) on {power} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("permu_diag and multimu_diag disagree")
    info.update(resume_s=resume_s, permu_s=permu_s, multimu_s=multi_s,
                rows=[dict({k: v for k, v in r.items() if k != "mu"},
                           floor=s["floor"], inspace=s["inspace"])
                      for r, s in zip(rows, split)],
                rel_gap=worst_same, sum_gap=worst_sum)

    errs, corner_s = timed(dev, lambda: corner_attrib.attribute(
        hrom, n_times=EX_CORNER_TIMES))
    print(f"  (e) corner_attrib at {EX_CORNER_TIMES} times (cut from 40), "
          f"{corner_s:.2f} s: " + ", ".join(
              f"{n} mean {e.mean():.3e} max {e.max():.3e}"
              for n, e in errs.items()) + f" on {power}")
    if not all(np.isfinite(e).all() for e in errs.values()):
        raise AssertionError("corner_attrib: not finite")
    info["corner"] = dict(seconds=corner_s, n_times=EX_CORNER_TIMES,
                          mean={n: float(e.mean()) for n, e in errs.items()},
                          max={n: float(e.max()) for n, e in errs.items()})

    (uh_fom, uh_hom), fom_s = timed(dev, lambda: window_study.validation_fom(
        hrom, cache=os.path.join(fleet_dir, window_study.FOM_CACHE)))
    floors, floor_s = timed(dev, lambda: window_study.study(
        hrom, argparse.Namespace(points=[EX_STUDY_FLOOR], floor_only=True,
                                 f32=False), uh_fom, uh_hom))
    W, N = EX_STUDY_SERVED
    served, served_s = timed(dev, lambda: window_study.served_point(
        hrom, W, N, uh_fom, uh_hom, f32=True))
    floor = floors[EX_STUDY_FLOOR]["floor"]
    ok = (np.isfinite(floor) and np.isfinite(served["drift"])
          and served["rel"] < 1.0)
    print(f"  (e) window_study --warm-dir: the FOM reference {fom_s:.2f} s; "
          f"--floor-only {EX_STUDY_FLOOR}: floor {floor:.3e} ({floor_s:.2f} "
          f"s); served {W}:{N} --f32: floor {served['floor']:.3e}, rel-L2 "
          f"{served['rel']:.3e}, f32 drift {served['drift']:.3e}, f32 "
          f"rel-L2 {served['rel32']:.3e} (build {served['build_s']:.1f} s, "
          f"solves {served['solve_s']:.1f} s) on {power} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("window_study: not finite")
    info["window_study"] = dict(fom_s=fom_s, floor_point=EX_STUDY_FLOOR,
                                floor_only=floor, served_point=f"{W}:{N}",
                                **served)

    from romtime_tpu_torch.kernel_ledger import phase_split, split_lines

    before = launch_counts(mods)
    t0 = time.perf_counter()
    args, kw = kernel_ledger.ledger_inputs(rom, EX_LEDGER_B)
    split = phase_split(args, kw, EX_LEDGER_REPS)
    gaps = kernel_ledger.twin_gaps(args, kw)
    ledger_s = time.perf_counter() - t0
    launches = launches_since(mods, before)
    print(f"  (e) kernel_ledger's inputs on cell 0's real tables "
          f"({rom.windows.n_windows}x{rom.windows.N}), B={EX_LEDGER_B}, "
          f"reps {EX_LEDGER_REPS}: the phase clocks (the ablation ledger "
          f"runs in (g)) and the variants against their twins, "
          f"{ledger_s:.1f} s, launches K1-K5 {launches}, on {power}:")
    for line in split_lines(split):
        print("    " + line)
    held = {n: g for n, g in gaps.items() if np.isfinite(g)}
    print(f"    each variant against its twin on the first "
          f"{kernel_ledger.TWIN_WINDOWS} windows: worst "
          f"{max(held.values()):.3e} of scale (limit "
          f"{kernel_ledger.TWIN_REL:.0e}); not finite in the twin and the "
          f"kernel alike: {[n for n in gaps if n not in held]}")
    if not launches[0] or any(launches[1:]):
        raise AssertionError(f"the ledger launched {launches}, expected K1 "
                             f"only")
    info["kernel_ledger"] = dict(seconds=ledger_s, B=EX_LEDGER_B,
                                 reps=EX_LEDGER_REPS, launches=launches,
                                 phase_split=split,
                                 twin_gaps={n: g if n in held else None
                                            for n, g in gaps.items()},
                                 max_abs_err=max(held.values()))
    return info


def example_entry(dev, power):
    """(f): the graft entry's forward on the card against the CPU's."""
    from romtime_tpu_torch.parallel import entry

    fwd, (mu,) = entry(dev)
    got, sec = timed(dev, lambda: fwd(mu))
    fwd_cpu, (mu_cpu,) = entry("cpu")
    want = fwd_cpu(mu_cpu)
    gap = float((got.cpu() - want).abs().max() / want.abs().max())
    ok = got.shape == want.shape and gap <= EX_ENTRY_REL
    print(f"  (f) entry(): the forward {tuple(got.shape)} float64 on the "
          f"card in {sec * 1e3:.1f} ms, within {gap:.2e} relative of the "
          f"CPU's (limit {EX_ENTRY_REL:.0e}) on {power} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("entry(): the card and the CPU differ")
    return dict(ms=sec * 1e3, rel_gap=gap)


def example_bench_entry(power, fleet_dir, center, diagnostics):
    """(g): ``python -m romtime_tpu_torch.bench`` in a subprocess on phase
    12's directory, warm, with ``BENCH_MULTI_MU=0`` and EX_BENCH_REPEAT
    calls a chain: its last line
    bench.py's payload with ``extra.device``, its center rel-L2 phase 12's
    ``center`` within EX_BENCH_CENTER_REL relative, its probe error within
    the fleet's limit, and its ledger's ``full_us_per_step`` within
    EX_BENCH_LEDGER_REL of the serving LU's µs/step that (e)'s phase
    clocks measured on a cell of the same shape (``diagnostics``: (e)'s
    result)."""
    from romtime_tpu_torch import bench as pb

    env = dict(os.environ, BENCH_DIR=fleet_dir, BENCH_MULTI_MU="0",
               BENCH_REPEAT=str(EX_BENCH_REPEAT))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "romtime_tpu_torch.bench"],
                          env=env, cwd=str(Path(__file__).resolve().parent),
                          capture_output=True, text=True,
                          timeout=EX_BENCH_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        print("    " + line)
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    if proc.returncode or not lines:
        raise AssertionError(f"the bench entry exited {proc.returncode}")
    payload = json.loads(lines[-1])
    extra = payload["extra"]
    center_gap = abs(payload["rel_l2_vs_fom"] - center) / center
    ledger = extra["kernel_ledger"] or {}
    split = diagnostics["kernel_ledger"]["phase_split"]["lu"]
    lu_us = split["ms"] * 1e3 / FLEET_BUILD_GRID["nt"]
    ledger_gap = abs(ledger.get("full_us_per_step", np.inf) - lu_us) / lu_us
    probe = extra["served_engine_probe_err"]
    ok = (tuple(payload) == pb.PAYLOAD_KEYS
          and tuple(extra) == pb.EXTRA_KEYS and extra["device"] == power
          and extra["rel_l2_multi_mu"] is None
          and center_gap <= EX_BENCH_CENTER_REL
          and probe is not None
          and probe <= pb.FLEET_CERT_LIMITS["served_engine_probe_err"]
          and ledger_gap <= EX_BENCH_LEDGER_REL)
    print(f"  (g) python -m romtime_tpu_torch.bench, warm on phase 12's "
          f"directory, BENCH_MULTI_MU=0, BENCH_REPEAT={EX_BENCH_REPEAT}: "
          f"exit {proc.returncode} in "
          f"{seconds:.1f} s; {payload['value']} solves/s on the active cell "
          f"({extra['n_windows']}x{extra['window_n']}); keys bench.py's and "
          f"extra.device; center rel-L2 {payload['rel_l2_vs_fom']:.4e}, "
          f"{center_gap:.1e} relative from phase 12's (limit "
          f"{EX_BENCH_CENTER_REL:.0e}); served_engine_probe_err "
          f"{probe:.4e} (limit "
          f"{pb.FLEET_CERT_LIMITS['served_engine_probe_err']:g}); the "
          f"ledger's full_us_per_step {ledger.get('full_us_per_step')} µs "
          f"against the serving LU's {lu_us:.2f} µs a step in (e), "
          f"{ledger_gap:.1%} apart (limit {EX_BENCH_LEDGER_REL:.0%}) on "
          f"{power} {'ok' if ok else 'FAIL'}; its payload:")
    print("    " + lines[-1])
    if not ok:
        raise AssertionError("the bench entry's line misses its checks")
    return dict(seconds=seconds, payload=payload, center_gap=center_gap,
                serving_lu_us=lu_us, ledger_gap=ledger_gap)


def examples_phase(mods, dev, power, fleet_dir, center):
    """Phase 16 of the module doc: the examples and the diagnostic
    scripts on the card, every launch counter read before and after
    (K1 from the ledger, K4 or K5 from the piston example; (g)'s entry
    runs in a process of its own). ``center``: phase 12's certified
    center rel-L2."""
    print(f"examples and diagnostics on {power}:")
    before = launch_counts(mods)
    info = {}
    for name, run in (
            ("poisson", lambda: example_poisson(dev, power)),
            ("heat_2d", lambda: example_heat_2d(dev, power)),
            ("piston", lambda: example_piston(mods, dev, power)),
            ("convergence", lambda: example_convergence(dev, power)),
            ("diagnostics", lambda: example_diagnostics(mods, dev, power,
                                                        fleet_dir)),
            ("entry", lambda: example_entry(dev, power)),
            ("bench_entry", lambda: example_bench_entry(
                power, fleet_dir, center, info["diagnostics"]))):
        t0 = time.perf_counter()
        info[name] = run()
        info[f"{name}_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    info["launches"] = launches_since(mods, before)
    if not info["launches"][0] or not (info["launches"][3]
                                       + info["launches"][4]):
        raise AssertionError(f"phase 16 launched {info['launches']}: K1 and "
                             f"one of K4, K5 expected")
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
        from romtime_tpu_torch import native
        from romtime_tpu_torch.testing import synthetic as synth
    except ImportError as exc:
        fail(f"the romtime_tpu_torch package is missing beside "
             f"chip_smoke.py ({exc})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    mods = {"k1": k1, "rs": rs, "gs": gs, "synth": synth, "native": native}
    if sys.argv[1:2] == [FLEET_BUILD_FLAG]:
        # Below the main process's priority: the build is off the run's
        # critical path, the phases beside it are on it.
        os.nice(FLEET_BUILD_NICE)
        with torch.inference_mode():
            fleet_cold_build(mods, dev, card(), sys.argv[2])
        return

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

    # K1's and K3's units under one key: the longest unit's seconds, each
    # unit's, and every instantiation of the three.
    units = {u: ptxas.pop(u) for u in WINDOWED_SERVING_UNITS}
    ptxas["windowed_serving"] = dict(
        nvcc_s=max(u["nvcc_s"] for u in units.values()),
        units_nvcc_s={name: u["nvcc_s"] for name, u in units.items()},
        kernels=[r for u in units.values() for r in u["kernels"]])

    errs = {k: [] for k in KERNELS}
    # Each phase's seconds since the last lap (phases 3-8; 9-16 also
    # print their own).
    phase_s, last = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        phase_s[name] = now - last[0]
        last[0] = now
        print(f"{name}: {phase_s[name]:.1f} s", flush=True)

    # Phase 12 builds its fleet in fleet_dir, in a process of its own from
    # the start of phase 9; phase 16 diagnoses it warm.
    fleet_dir = tempfile.mkdtemp()
    builder = None
    try:
        with torch.inference_mode():
            rich_errs = []
            rows, splits = kernel_phase(mods, dev, power, errs, rich_errs)
            lap("kernel phase")
            modes, ablations, ledgers = k1_options_phase(mods, dev, power)
            lap("K1 options phase")
            rows += global_kernel_phase(mods, dev, power, errs)
            lap("global kernel phase")
            launches, kernels, serving = serving_phase(mods, dev, power, errs,
                                                       rich_errs)
            lap("windowed serving phase")
            gkernels, gserving, rom15, mus = global_serving_phase(mods, dev,
                                                                  power, errs)
            lap("global serving phase")
            autotune = autotune_phase(rom15, mus, repo, power)
            del rom15, mus
            torch.cuda.empty_cache()
            lap("autotune phase")
            fleet = fleet_phase(mods, dev, power)
            torch.cuda.empty_cache()
            lap("fleet phase")
            builder = start_fleet_build(fleet_dir)
            t0 = time.perf_counter()
            certification = certification_phase(mods, dev, power)
            certification["seconds"] = time.perf_counter() - t0
            print(f"certification phase: {certification['seconds']:.1f} s")
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            launches_before = [c.launches for c in counters(mods)]
            fom, fom_batch = fom_phase(dev, power)
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
            single = online_single_phase(mods, dev, power, built)
            single["seconds_phase"] = time.perf_counter() - t0
            del built
            print(f"online single-μ and evaluation phase: "
                  f"{single['seconds_phase']:.1f} s, launches K1-K5 "
                  f"{single['launches']} (none: no kernel on this path)")
            if any(single["launches"]):
                raise AssertionError("the single-μ phase launched a serving "
                                     "kernel")
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            heat = heat_phase(mods, dev, power)
            heat["seconds_phase"] = time.perf_counter() - t0
            print(f"heat phase: {heat['seconds_phase']:.1f} s, launches "
                  f"{heat['launches']} (K1 windowed, K4 and K5 global, "
                  f"with_trilinear=False, BDF-1)")
            for k in ("K1", "K4", "K5"):
                if not heat["launches"].get(k):
                    raise AssertionError(f"the heat phase never launched {k}")
                errs[k].append(heat["kernels"][k]["max_abs_err"])
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            multi = multi_device_phase(mods, dev, power, fom_batch,
                                       fom["f32_plain"]["seconds"])
            del fom_batch
            multi["seconds_phase"] = time.perf_counter() - t0
            print(f"multi-device phase: {multi['seconds_phase']:.1f} s, "
                  f"launches K1-K5 {multi['launches']} (none: no kernel on "
                  f"the sharded paths)")
            if any(multi["launches"]):
                raise AssertionError("the multi-device phase launched a "
                                     "serving kernel")
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            fleet_build = fleet_build_phase(mods, dev, power, fleet_dir,
                                            builder)
            fleet_build["seconds_phase"] = time.perf_counter() - t0
            print(f"fleet build phase: {fleet_build['seconds_phase']:.1f} s, "
                  f"launches K1-K5 of its served calls "
                  f"{fleet_build['launches']}")
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            examples = examples_phase(
                mods, dev, power, fleet_dir,
                fleet_build["certification"]["rel_l2_vs_fom"])
            examples["seconds_phase"] = time.perf_counter() - t0
            print(f"examples and diagnostics phase: "
                  f"{examples['seconds_phase']:.1f} s, launches K1-K5 "
                  f"{examples['launches']} (K1 the ledger's, K4/K5 the "
                  f"piston example's)")
            lap("phases 9-16")
    finally:
        if builder is not None and builder.poll() is None:
            builder.kill()
            builder.wait()
        shutil.rmtree(fleet_dir, ignore_errors=True)
    errs["K1"].append(examples["diagnostics"]["kernel_ledger"]["max_abs_err"])
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
        online_single_launches=single["launches"][i],
        heat_launches=heat["launches"].get(k, 0),
        examples_launches=examples["launches"][i],
        heat={n: v for n, v in heat["kernels"].get(k, {}).items()
              if n != "max_abs_err"}, **kernels[k])
        for i, k in enumerate(KERNELS)],
        "shapes": rows, "serving": serving, "autotune": autotune,
        "fleet": fleet, "certification": certification, "fom": fom,
        "offline_build": build, "fleet_build": fleet_build,
        "online_single": single,
        "heat": {k: v for k, v in heat.items() if k != "kernels"},
        "multi_device": multi,
        "examples": examples, "phase_seconds": phase_s,
        "card": power}, default=float))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
