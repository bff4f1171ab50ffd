"""Readings that the limits of ``correct`` are set from, on the card at
the cell's own size and load, in one process:

- the program's: for each seed, the cell's artifacts and traffic drawn
  as a run draws them, one warm-up call and ``--calls`` calls of the
  window's first batches through the entry, the rows a run checks
  sampled from them, and the numbers compared against the float64
  reference (:mod:`benchmark.reference.compare`);
- the controls': for each control seed, the reference itself put in the
  program's place and computed below the configuration's precision (the
  workload's ``check.controls``, :data:`CONTROLS`), held against the
  float64 reference the same way. The fleet serves float32 with TF32 off
  and a double-float32 state carry: its controls are plain float32 with
  TF32 off and no carry, the step just below, and TF32. The global ROM
  serves float32 with TF32 off: its control is TF32. TF32 is worked by
  rounding every operand of a product to TF32 (:func:`benchmark.
  reference.sweep.tf32`): the library's own TF32 switch only allows it,
  and for some shapes its kernels stay in float32. Each control has to
  fail one of the cell's numbers.

    python3 -m benchmark.checks.calibrate --workload <cell> \
        --seeds 1 2 ... --control-seeds 1 2 3 [--calls 3]

Prints one JSON line per seed and side (with the seconds the reference
took), then the lower reading (the largest of the program's) and the
upper ones (the smallest of each control's) of each number.
"""

import argparse
import gc
import json
import sys
import time

import numpy as np
import torch

from .. import harness, run
from ..reference import compare
from ..traffic.artifacts import draw_payload
from ..traffic.generator import Traffic

#: Control name → whether its products are TF32 (always float32, with
#: the library's own TF32 off, so that the rounding is the same whatever
#: kernel a shape gets).
CONTROLS = {"float32": False, "tf32": True}


def served_rows(work, config, mix, seed, calls, device):
    """(payload, μ rows, cells, served rows) of ``calls`` window calls of
    seed ``seed``, the rows kept and sampled as a run keeps and samples
    them."""
    payload = draw_payload(config, seed, device)
    rom, serve = run.build_system(config, payload, device)
    traffic = Traffic(mix, config["mu_box"], seed)
    serve(traffic.as_dicts(traffic.warm()[0]))
    pool = harness.Calls(traffic, payload, work["check"]["keep_per_call"],
                         seed, calls)
    kept = harness.Kept()
    for i in range(calls):
        batch, rows, groups = pool[i]
        kept.add(batch, rows, groups, serve(traffic.as_dicts(batch)))
    del rom, serve
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    mu, groups, pick = kept.sample(work["check"]["rows_per_cell"], seed)
    return payload, mu, groups, kept.served(pick)


def control_rows(payload, config, groups, mu, device, control):
    """The reference at the precision of ``control`` (:data:`CONTROLS`),
    in the program's place."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return compare.reference_rows(payload, config, groups, mu,
                                  dtype=torch.float32, device=device,
                                  tf32_products=CONTROLS[control])


def readings(work, config, mix, seeds, control_seeds, calls, device):
    """JSON-able readings: one dict per (seed, side), with the cell's
    verdict (``correct``) as a run would give it."""
    out = []
    controls = work["check"]["controls"]
    for seed in seeds:
        payload, mu, groups, served = served_rows(work, config, mix, seed,
                                                  calls, device)
        torch.backends.cuda.matmul.allow_tf32 = False
        t0 = time.perf_counter()
        ref = compare.reference_rows(payload, config, groups, mu,
                                     device=device)
        ref_s = time.perf_counter() - t0
        sides = [("program", served)]
        for name in controls if seed in control_seeds else ():
            sides.append((f"control.{name}",
                          control_rows(payload, config, groups, mu, device,
                                       name)))
        for side, rows in sides:
            ok, checks = harness.verdict(rows, ref, config, groups, work)
            row = {"seed": seed, "side": side, "rows": len(groups),
                   "correct": ok, "reference_s": ref_s,
                   **{k: c["value"] for k, c in checks.items()
                      if k != "failed_mu"}}
            out.append(row)
            print(json.dumps(row), flush=True)
    return out


def summary(rows):
    """name → {"lower": largest program reading, "upper.<control>":
    smallest reading of each control}."""
    skip = ("seed", "side", "rows", "correct", "reference_s")
    names = {k for r in rows for k in r if k not in skip}
    sides = sorted({r["side"] for r in rows} - {"program"})
    out = {}
    for k in sorted(names):
        prog = [r[k] for r in rows if r["side"] == "program" and k in r]
        out[k] = {"lower": max(prog) if prog else None}
        for side in sides:
            ctl = [r[k] for r in rows if r["side"] == side and k in r]
            out[k][f"upper.{side[len('control.'):]}"] = min(ctl)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=())
    ap.add_argument("--calls", type=int, default=3)
    args = ap.parse_args(argv)
    run.configure_environment(run.HERE.parent)
    if not torch.cuda.is_available():
        print("calibration needs a CUDA device", file=sys.stderr)
        return 2
    work, config, mix = harness.load_cell(args.workload)
    rows = readings(work, config, mix, args.seeds, set(args.control_seeds),
                    args.calls, "cuda")
    print(json.dumps({"workload": args.workload,
                      "summary": summary(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
