"""Measured per-component ledger of K1, the fused windowed serving
kernel, on a warm build's real tables (counterpart of
``scripts/kernel_ledger.py``).

Runs K1 at the build's operating point (a resumed build directory:
its active windows, or fleet cell 0 where it has a fleet) with pieces
of its work ablated in turn (``romtime_tpu_torch/kernel_ledger.py``:
every variant on K1's
first design, timed with CUDA events, the median of ``reps`` calls),
then the serving design's phase clocks on the same inputs, and holds
each ablation variant against K1's plain PyTorch twin on the first
windows (5e-5 of the largest value).

    BENCH_DIR=DIR python -m romtime_tpu_torch.scripts.kernel_ledger
        [B] [reps] [--device cuda]

Prints one line per variant (ms a sweep, µs a step of the whole batch),
the derived component costs (θ dots, solve, boundary, floor) and the
phase shares. The ``no_trilinear`` row needs tables built without the
trilinear term, which a build's tables fold in: it is skipped, as the
JAX script skips it. The ledger times the card: on CPU tensors it
raises (``ValueError``), as ``romtime_tpu_torch/kernel_ledger.py`` does.
"""

import argparse
import math
import os

import numpy as np
import torch

from ..conventions import PistonParameters, Stage
from ..dtypes import compute_dtype_scope
from ..utils.cli import add_device_argument, resolve_device

#: Variant against twin: the largest difference over the largest value.
TWIN_REL = 5e-5
#: Windows of the variant-against-twin comparisons.
TWIN_WINDOWS = 4


def ledger_window(rom):
    """The windows the ledger runs on, made the active ones: fleet cell 0
    where a fleet is attached, else the attached windows."""
    ml = rom.mulocal
    win = ml.cells[0] if ml is not None else rom.windows
    if win is None:
        raise ValueError("the build has no windowed serving configuration")
    rom._set_serving_windows(win)
    return win


def ledger_mus(rom, B):
    """64 Mach-stratified μ (``RandomState(3)``) cycled to ``B``, the Mach
    key dropped (the JAX script's batch)."""
    mus = list(rom.build_sampling_space(num=64,
                                        rnd=np.random.RandomState(3)))
    mus = (mus * math.ceil(B / len(mus)))[:B]
    return [{k: float(v) for k, v in m.items()
             if k != PistonParameters.MACH_PISTON} for m in mus]


def ledger_inputs(rom, B=2048):
    """K1's (args, kw) on the build's real tables: the windows of
    :func:`ledger_window`, the θ prep of :func:`ledger_mus` in float32,
    the per-step LU (the kernel ledger replaces the solve per variant)."""
    from ..rom.engines.windowed_fused import sweep_inputs

    win = ledger_window(rom)
    mus = ledger_mus(rom, B)
    for mu in mus:
        rom.add_mu(mu=mu, step=Stage.ONLINE)
    with compute_dtype_scope(torch.float32):
        tables = rom._windowed_tables()
        prepped = rom.prep(mus)
    return sweep_inputs(rom.fom, win, prepped, tables, (None, None, "sub1"))


def first_windows(args, kw, n):
    """K1's inputs cut to their first ``n`` windows."""
    width = kw["widths"][0]
    n = min(n, len(kw["widths"]))
    return ((args[0][:n * width], *(a[:n] for a in args[1:8]), args[8],
             args[9]), dict(kw, widths=(width,) * n))


def ledger_variants():
    """(name, K1 options) of every ledger variant that runs on a build's
    tables: the LU schedule's and Richardson's, ``no_trilinear`` out."""
    from ..kernel_ledger import LU_VARIANTS, RICHARDSON_VARIANTS

    return ([(f"lu {n}", o) for n, o in LU_VARIANTS if n != "no_trilinear"]
            + [(f"richardson {n}", o) for n, o in RICHARDSON_VARIANTS])


def twin_gaps(args, kw, n_windows=TWIN_WINDOWS):
    """{variant: the largest difference of K1's probes and carried state
    from its twin's on the first ``n_windows`` windows, over the twin's
    largest value}. Raises ``AssertionError`` above :data:`TWIN_REL`. A
    variant whose twin is not finite (an ablation can leave the solve
    singular on a build's tables: Richardson without the θ products) is
    held to be not finite on the kernel too, and its gap is NaN."""
    from ..ops.windowed_fused import (
        online_sweep_windowed_fused,
        windowed_fused_reference,
    )

    a, k = first_windows(args, kw, n_windows)
    base = dict(k, paired_lu=None, paired_mode="sub1", solve_iters=None,
                ablate=None)
    gaps = {}
    for name, opts in ledger_variants():
        kv = dict(base, **opts)
        got = online_sweep_windowed_fused(*a, **kv)
        want = windowed_fused_reference(*a, **kv)
        pairs = ((got[0], want[0]), (got[1][[0, 2]], want[1][[0, 2]]))
        finite = [bool(torch.isfinite(t).all()) for p in pairs for t in p]
        if not all(finite[1::2]):
            if all(finite[0::2]):
                raise AssertionError(f"K1 {name} is finite where its twin "
                                     f"is not")
            gaps[name] = float("nan")
            continue
        if not all(finite):
            raise AssertionError(f"K1 {name}: not finite")
        gap = max((g - w).abs().max().item()
                  / max(w.abs().max().item(), 1e-30) for g, w in pairs)
        if gap > TWIN_REL:
            raise AssertionError(f"K1 {name} is {gap:.3e} of scale from "
                                 f"its twin (limit {TWIN_REL:.0e})")
        gaps[name] = gap
    return gaps


def ledger(args, kw, reps=3, served=None):
    """The ablation ledger and the phase split of K1 on ``args``/``kw``
    (``romtime_tpu_torch/kernel_ledger.py``), ``bench.py``'s keys at the
    served solve ``served`` (``rom.windowed_solve()``'s triple; default
    the per-step LU); raises on CPU tensors."""
    from ..kernel_ledger import PER_STEP_LU, kernel_ledger, phase_split

    return (kernel_ledger(args, kw, reps=reps, served=served or PER_STEP_LU),
            phase_split(args, kw, reps))


def main(argv=None):
    from ..kernel_ledger import ledger_lines, split_lines
    from ..problems import joint_profile
    from .permu_diag import build_hrom

    parser = add_device_argument(argparse.ArgumentParser(description=__doc__))
    parser.add_argument("B", nargs="?", type=int, default=2048)
    parser.add_argument("reps", nargs="?", type=int, default=3)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if device.type != "cuda":
        raise ValueError("the kernel ledger times K1 on a CUDA device")
    nx = int(os.environ.get("BENCH_NX", 1000))
    nt = int(os.environ.get("BENCH_NT", 1500))
    hrom = build_hrom(os.environ.get("BENCH_DIR", ".bench_warm"),
                      joint_profile(nx=nx, nt=nt), device)
    with torch.inference_mode():
        kargs, kw = ledger_inputs(hrom.rom, args.B)
        costs, split = ledger(kargs, kw, args.reps,
                              served=hrom.rom.windowed_solve())
        gaps = twin_gaps(kargs, kw)
    for line in ledger_lines(costs, args.B) + split_lines(split):
        print(line)
    held = [g for g in gaps.values() if np.isfinite(g)]
    print("[ledger] each variant against its twin on the first "
          f"{TWIN_WINDOWS} windows: worst {max(held):.3e} of scale (limit "
          f"{TWIN_REL:.0e}); not finite in both: "
          f"{[n for n, g in gaps.items() if not np.isfinite(g)]}")
    return costs, split, gaps


if __name__ == "__main__":
    main()
