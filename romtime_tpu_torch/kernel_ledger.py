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
term); with the Richardson solve (5 iterations, or the served count when
the served solve is Richardson): ``full``, ``no_solve``, ``no_dots``,
``no_boundary``, ``empty``. The components, in µs per step of the whole
batch and clamped at 0 as ``bench.py`` clamps them: θ dots = full −
no_dots, solve = full − no_solve, trilinear = full − no_trilinear (LU
only), boundary dd = full − no_boundary, floor = empty.

**``bench.py``'s four keys** describe the served solve (``served``, the
triple ``rom.windowed_solve()`` returns: the per-step LU, the paired LU
at its group and follower mode, or Richardson at its iterations), as
``bench.py`` :900-915 times the timed engine's own setting.
``full_us_per_step`` is the unablated sweep at that setting through
:func:`~romtime_tpu_torch.ops.windowed_fused.online_sweep_windowed_fused`,
the design ``solve_batch`` launches (the serving design, but for the
paired follower modes other than ``sub1``). ``solve_us_per_step``,
``overhead_us_per_step`` and ``dd_transfer_frac`` are differences of the
first design's rows at the same setting (its unablated row against
``no_solve``, ``empty`` and ``no_boundary``), the only design with an
``ablate`` path. :func:`bench_sources` names each key's rows and design.

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
    GJ_FORI_MIN,
    SERVING_PHASES,
    _first_design_sweep,
    _serving_sweep_clocked,
    k1_design,
    online_sweep_windowed_fused,
)

GROUP = 5
SOLVE_ITERS = 5
#: The port's served solve by default: the per-step LU
#: (``rom/engines/policy.py``), as ``rom.windowed_solve()`` returns it.
PER_STEP_LU = (None, None, "sub1")
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


def served_rows(served):
    """(the first design's ledger, its unablated row at the served
    setting, that row's K1 options) for ``served`` = (solve_iters,
    paired-LU group, follower mode): Richardson's ``full`` at its
    iterations, the LU ledger's ``full`` for the per-step LU, or its
    ``full_paired5`` (``full_paired{G}``, with ``_{mode}`` for a mode
    other than ``sub1``) for the paired LU."""
    iters, group, mode = served
    if iters:
        return "richardson", "full", {"solve_iters": int(iters)}
    if not group or group < 2:
        return "lu", "full", {}
    name = f"full_paired{group}" + ("" if mode == "sub1" else f"_{mode}")
    return "lu", name, {"paired_lu": int(group), "paired_mode": mode}


def kernel_ledger(args, kw, no_trilinear=None, reps=3, served=PER_STEP_LU):
    """The ablation ledger of K1's first design on ``args``/``kw`` (its
    inputs and options as
    :func:`~romtime_tpu_torch.ops.windowed_fused.online_sweep_windowed_fused`
    takes them; the solve options in ``kw`` are replaced by each
    variant's), and ``bench.py``'s four keys at the served solve
    ``served`` (``rom.windowed_solve()``'s triple; default the per-step
    LU). ``no_trilinear`` is the (args, kw) pair of the same inputs built
    without the trilinear term, or None to skip that row. Returns
    {"lu": ..., "richardson": ..., "served": ..., "bench": ...}: per solve
    the ms per sweep and µs per step of each variant and the derived
    components; ``served`` the unablated sweep at the served setting
    through the wrapper (its design, ms and µs) and the first design's row
    at that setting; ``bench`` holds ``bench.py``'s four keys."""
    for a in (args, no_trilinear[0] if no_trilinear else args):
        _check_cuda(a)
    base = dict(kw, paired_lu=None, paired_mode="sub1", solve_iters=None,
                ablate=None)
    tri = None
    if no_trilinear is not None:
        tri = (no_trilinear[0], dict(no_trilinear[1], **{
            k: base[k] for k in ("paired_lu", "paired_mode", "solve_iters",
                                 "ablate")}))
    part, row, opts = served_rows(served)
    lu_variants = LU_VARIANTS
    if part == "lu" and row not in dict(LU_VARIANTS):
        lu_variants = LU_VARIANTS + ((row, opts),)
    rich_variants = RICHARDSON_VARIANTS
    if part == "richardson":
        rich_variants = tuple((name, dict(o, **opts))
                              for name, o in RICHARDSON_VARIANTS)
    lu = _solve_ledger(lu_variants, args, base, tri, reps)
    rich = _solve_ledger(rich_variants, args, base, None, reps)
    nt = args[0].shape[0]
    sopts = dict(base, **opts)
    served_ms = time_sweep(args, sopts, reps, online_sweep_windowed_fused)
    group = sopts["paired_lu"] or 0
    if (sopts["solve_iters"] is not None or group < 2
            or sopts["n_real"] <= GJ_FORI_MIN):
        group = 0
    us = ({"lu": lu, "richardson": rich}[part])["us_per_step"]
    first = us[row]
    full = served_ms * 1e3 / nt
    bench = {
        "full_us_per_step": full,
        "solve_us_per_step": max(first - us["no_solve"], 0.0),
        "overhead_us_per_step": max(us["empty"], 0.0),
        "dd_transfer_frac": max(first - us["no_boundary"], 0.0)
        / max(first, 1e-9),
    }
    return {"lu": lu, "richardson": rich,
            "served": {"setting": list(served), "ledger": part, "row": row,
                       "design": k1_design(group, sopts["paired_mode"],
                                           None),
                       "ms_per_sweep": served_ms, "us_per_step": full,
                       "first_design_us_per_step": first},
            "bench": bench}


def bench_sources(ledger):
    """bench key → the rows and the design it comes from, for
    :func:`kernel_ledger`'s result."""
    s = ledger["served"]
    part, row = s["ledger"], s["row"]
    return {
        "full_us_per_step": f"the {s['design']} design, the served call "
                            f"({solve_name(s['setting'])})",
        "solve_us_per_step": f"the first design, {part} {row} − {part} "
                             f"no_solve",
        "overhead_us_per_step": f"the first design, {part} empty",
        "dd_transfer_frac": f"the first design, ({part} {row} − {part} "
                            f"no_boundary) / {part} {row}",
    }


def solve_name(served):
    """A served setting (solve_iters, group, mode) in words."""
    iters, group, mode = served
    if iters:
        return f"Richardson, {iters} iterations"
    if group and group >= 2:
        return f"paired LU G={group} {mode}"
    return "per-step LU"


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
    s = ledger["served"]
    lines.append(f"[ledger] served {solve_name(s['setting'])}: "
                 f"{s['ms_per_sweep']:9.3f} ms/sweep {s['us_per_step']:8.2f} "
                 f"us/step on the {s['design']} design")
    sources = bench_sources(ledger)
    lines.append("[ledger] bench.py keys at the served setting: " + "; ".join(
        f"{k} {v:.4g} ({sources[k]})" for k, v in ledger["bench"].items()))
    return lines
