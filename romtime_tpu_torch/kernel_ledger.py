"""Measured per-component cost ledgers of K1 (the fused windowed sweep)
on the card.

**The first design's ablation ledger** (``csrc/windowed_fused.cu``, the
counterpart of ``scripts/kernel_ledger.py`` and of the ledger in
``bench.py`` :876-959): the first design runs on the same inputs with one
piece of its work taken out at a time (``ablate``), and the differences
of the sweep times are the pieces' costs. Every variant, the unablated
ones included, runs on the first design (``_first_design_sweep``), so the
differences are of one design. Each variant is timed with CUDA events
around single calls, the median of ``reps`` calls after one warm-up (the
reference's chained-marginal protocol existed only because its TPU
backend did not block on a result; a CUDA event does).

Variants with the LU schedule: ``full`` (per-step LU), ``full_paired5``
(paired LU G=5, ``sub1``), ``no_solve``, ``no_dots``, ``no_boundary``,
``empty`` and ``no_trilinear`` (on tables built without the trilinear
term); with the Richardson solve: ``full``, ``no_solve``, ``no_dots``,
``no_boundary``, ``empty``. The components, in µs per step of the whole
batch and clamped at 0 as ``bench.py`` clamps them: θ dots = full −
no_dots, solve = full − no_solve, trilinear = full − no_trilinear (LU
only), boundary dd = full − no_boundary, floor = empty. ``bench.py``'s
four keys come from the ``full_paired5`` row (the serving solve), as its
ablations time the served engine's paired setting.

**The serving body's phase split** (``csrc/serving_body.cuh``): its
CLOCKED instantiation (the same compiled body with clock() reads by
one thread at each phase boundary) gives each block's cycles per phase;
:func:`phase_split` times it beside the plain instantiation for K1, for
the paired LU (G=5, ``sub1``), the per-step LU and Richardson (5
iterations), and :func:`body_phase_split` for one K2 or K3 launch or
one K4 or K5 sweep; each reports the shares only where the two totals agree within
:data:`CLOCK_GAP_MAX`.

Used from ``chip_smoke.py``. Each raises on a CPU tensor: there is no
ledger of the twin.
"""

import statistics

import torch

from .ops import global_sweep, resid_sweep
from .ops.windowed_fused import (
    SERVING_PHASES,
    _first_design_sweep,
    _serving_sweep_clocked,
    online_sweep_windowed_fused,
)

GROUP = 5
SOLVE_ITERS = 5
#: (variant, K1 options) with the LU schedule; "no_trilinear" runs the
#: unablated kernel on the tables built without the trilinear term.
LU_VARIANTS = (("full", {}),
               ("full_paired5", {"paired_lu": GROUP}),
               ("no_solve", {"ablate": "no_solve"}),
               ("no_dots", {"ablate": "no_dots"}),
               ("no_boundary", {"ablate": "no_boundary"}),
               ("empty", {"ablate": "empty"}),
               ("no_trilinear", {}))
RICHARDSON_VARIANTS = tuple((name, dict(opts, solve_iters=SOLVE_ITERS))
                            for name, opts in LU_VARIANTS
                            if name in ("full", "no_solve", "no_dots",
                                        "no_boundary", "empty"))
#: (component, the variant that leaves it out).
COMPONENTS = (("theta_dots", "no_dots"), ("solve", "no_solve"),
              ("trilinear", "no_trilinear"), ("boundary_dd", "no_boundary"))


#: Largest relative gap between the clocked and the plain serving design's
#: sweep times at which the phase shares are reported.
CLOCK_GAP_MAX = 0.03
#: (name, K1 options) of the phase split's solves.
SPLIT_SOLVES = (("sub1", {"paired_lu": GROUP}),
                ("lu", {"paired_lu": None}),
                ("richardson", {"solve_iters": SOLVE_ITERS}))


def time_sweep(args, kw, reps, sweep=_first_design_sweep):
    """Median ms of ``reps`` calls of ``sweep`` (default: K1's first
    design) after one warm-up call, each call between two CUDA events."""
    sweep(*args, **kw)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        sweep(*args, **kw)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _solve_ledger(variants, args, kw, no_trilinear, reps):
    nt = args[0].shape[0]
    ms = {}
    for name, opts in variants:
        if name == "no_trilinear":
            if no_trilinear is None:
                continue
            a, k = no_trilinear
        else:
            a, k = args, kw
        ms[name] = time_sweep(a, dict(k, **opts), reps)
    us = {name: t * 1e3 / nt for name, t in ms.items()}
    components = {part: max(us["full"] - us[key], 0.0)
                  for part, key in COMPONENTS if key in us}
    components["floor"] = max(us["empty"], 0.0)
    return {"ms_per_sweep": ms, "us_per_step": us,
            "components_us_per_step": components}


def kernel_ledger(args, kw, no_trilinear=None, reps=3):
    """The ablation ledger of K1's first design on ``args``/``kw`` (its inputs and options as
    :func:`~romtime_tpu_torch.ops.windowed_fused.online_sweep_windowed_fused`
    takes them; the solve options in ``kw`` are replaced by each
    variant's). ``no_trilinear`` is the (args, kw) pair of the same inputs
    built without the trilinear term, or None to skip that row. Returns
    {"lu": ..., "richardson": ..., "bench": ...}: per solve the ms per
    sweep and µs per step of each variant and the derived components;
    ``bench`` holds ``bench.py``'s four ledger keys."""
    for a in (args, no_trilinear[0] if no_trilinear else args):
        _check_cuda(a)
    base = dict(kw, paired_lu=None, paired_mode="sub1", solve_iters=None,
                ablate=None)
    tri = None
    if no_trilinear is not None:
        tri = (no_trilinear[0], dict(no_trilinear[1], **{
            k: base[k] for k in ("paired_lu", "paired_mode", "solve_iters",
                                 "ablate")}))
    lu = _solve_ledger(LU_VARIANTS, args, base, tri, reps)
    rich = _solve_ledger(RICHARDSON_VARIANTS, args, base, None, reps)
    us = lu["us_per_step"]
    full = us["full_paired5"]
    bench = {
        "full_us_per_step": full,
        "solve_us_per_step": max(full - us["no_solve"], 0.0),
        "overhead_us_per_step": max(us["empty"], 0.0),
        "dd_transfer_frac": max(full - us["no_boundary"], 0.0)
        / max(full, 1e-9),
    }
    return {"lu": lu, "richardson": rich, "bench": bench}


def _check_cuda(args):
    if not args[0].is_cuda:
        raise ValueError("the kernel ledger times K1 on a CUDA device; "
                         f"got a tensor on {args[0].device}")


def phase_split(args, kw, reps=3):
    """The serving design's phase clocks on ``args``/``kw`` for each of
    :data:`SPLIT_SOLVES` (its options replace the solve options in
    ``kw``): {solve: {"ms", "clocked_ms", "gap", "shares",
    "cycles_per_step"}}. ``ms`` and ``clocked_ms`` are medians of
    ``reps`` calls (CUDA events) of the plain and the CLOCKED
    instantiation, in turns; ``gap`` = |clocked − plain| / plain;
    ``shares`` the phases' fractions of the blocks' summed cycles (None
    where ``gap`` exceeds :data:`CLOCK_GAP_MAX`); ``cycles_per_step`` the
    mean block's cycles per phase and step."""
    _check_cuda(args)
    base = dict(kw, paired_lu=None, paired_mode="sub1", solve_iters=None,
                ablate=None)
    return {name: _clock_split(args, dict(base, **opts), reps,
                               online_sweep_windowed_fused,
                               _serving_sweep_clocked)
            for name, opts in SPLIT_SOLVES}


#: (plain wrapper, CLOCKED entry) of K2-K5 on the serving body.
BODY_CLOCKED = {
    "K2": (resid_sweep.online_sweep_pallas_v2, resid_sweep._v2_clocked),
    "K3": (resid_sweep.online_sweep_theta_pallas_v2,
           resid_sweep._theta_v2_clocked),
    "K4": (global_sweep.online_sweep_pallas, global_sweep._tables_clocked),
    "K5": (global_sweep.online_sweep_theta_pallas,
           global_sweep._theta_clocked),
}


def body_phase_split(kernel, args, kw, reps=3):
    """The serving body's phase clocks of one K2 or K3 launch or one K4
    or K5 sweep (``kernel``) on its wrapper's ``args``/``kw``: {"lu": ...}
    with the entries of :func:`phase_split` (their one solve is the
    per-step LU, or K4's and K5's Gauss-Jordan)."""
    _check_cuda(args)
    return {"lu": _clock_split(args, kw, reps, *BODY_CLOCKED[kernel])}


def _clock_split(args, kw, reps, plain_fn, clocked_fn):
    """Plain and clocked times in turns and the clocked run's phase
    shares (None over :data:`CLOCK_GAP_MAX`)."""
    nt = args[0].shape[0]
    plain = time_sweep(args, kw, reps, plain_fn)
    clocked = time_sweep(args, kw, reps, clocked_fn)
    plain = min(plain, time_sweep(args, kw, reps, plain_fn))
    clk = clocked_fn(*args, **kw)[2].double()
    sums = clk.sum(dim=0)
    gap = abs(clocked - plain) / plain
    per_step = (sums[:-1] / clk.shape[0] / nt).tolist()
    shares = ({p: (sums[j] / sums[-1]).item()
               for j, p in enumerate(SERVING_PHASES)}
              if gap <= CLOCK_GAP_MAX else None)
    return {"ms": plain, "clocked_ms": clocked, "gap": gap,
            "shares": shares,
            "cycles_per_step": dict(zip(SERVING_PHASES, per_step))}


def split_lines(split):
    """Printable lines of :func:`phase_split`'s result."""
    lines = []
    for name, r in split.items():
        head = (f"[phases] {name:10s} plain {r['ms']:9.3f} ms, clocked "
                f"{r['clocked_ms']:9.3f} ms (gap {r['gap']:.2%})")
        if r["shares"] is None:
            lines.append(head + f": over {CLOCK_GAP_MAX:.0%}, shares not "
                         "reported")
        else:
            lines.append(head + ": " + ", ".join(
                f"{p} {v:.1%}" for p, v in r["shares"].items()))
    return lines


def ledger_lines(ledger, B):
    """Printable lines of :func:`kernel_ledger`'s result, in the layout of
    ``scripts/kernel_ledger.py``."""
    lines = []
    for solve in ("lu", "richardson"):
        part = ledger[solve]
        for name, ms in part["ms_per_sweep"].items():
            lines.append(f"[ledger] {solve:10s} {name:13s} {ms:9.3f} "
                         f"ms/sweep {part['us_per_step'][name]:8.2f} us/step")
        lines.append(f"[ledger] {solve:10s} derived (us/step, whole batch "
                     f"B={B}): " + ", ".join(
                         f"{k} {v:.2f}" for k, v in
                         part["components_us_per_step"].items()))
    lines.append("[ledger] bench.py keys (full_paired5 row): " + ", ".join(
        f"{k} {v:.4g}" for k, v in ledger["bench"].items()))
    return lines
