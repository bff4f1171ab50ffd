"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for. Set-up draws the cell's serving artifacts and μ from the seed,
loads them into ``romtime_tpu_torch`` (the system under test; this is
the only module of the benchmark that imports it), and warms up every
shape the cell's traffic uses; then one closed-loop client calls the
entry back to back for ``--seconds``. ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics, read from spans
around the calls and from ``torch.profiler`` over a few calls inside the
window. After the window the served rows of a seeded sample are held
against the plain reference (``benchmark/reference``); each number
compared is printed beside its limit, last on standard error and under
``checks`` in the result, the last line of standard output.

Exits non-zero, printing no result, without the card(s), when a run
loaded JAX or the JAX package, or when the system cannot be imported.
"""

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
#: Modules no run may load, compared by whole top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "romtime_tpu")
#: Host threads of the numeric libraries: one process with few threads.
HOST_THREADS = "4"


def process_start():
    """perf_counter() at this process's start (from /proc), or now."""
    try:
        with open("/proc/self/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


def configure_environment(checkout):
    """Fixed build and kernel cache directories inside the checkout, the
    program's serving options as its configuration states them (no
    ``ROMTIME_*`` override), few host threads."""
    for key in [k for k in os.environ if k.startswith("ROMTIME_")]:
        del os.environ[key]
    build = Path(checkout) / "build"
    os.environ["ROMTIME_TORCH_BUILD_DIR"] = str(build / "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = HOST_THREADS


def forbidden_modules():
    """Top-level names of loaded modules that no run may load."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


# ----------------------------------------------------------------------
# The system under test
# ----------------------------------------------------------------------
def build_system(config, payload, device):
    """The port's serving object loaded from ``payload`` and ``serve(mus,
    hook=None)``: the configuration's entry on a list of μ dicts, batch-
    first numpy outputs on the host; ``hook(run_cell)`` wraps each
    per-cell sweep of a fleet (the entry's ``sweep_fn``)."""
    from romtime_tpu_torch import convert

    if config["kind"] == "fleet":
        rom = convert.fleet_serving_from_arrays(payload, device=device)

        def serve(mus, hook=None):
            sweep_fn = None
            if hook is not None:
                sweep_fn = hook(lambda sub: rom.solve_batch(sub,
                                                            mode="probes"))
            return rom.solve_batch_mulocal(mus, mode="probes",
                                           sweep_fn=sweep_fn)
        return rom, serve
    rom = convert.global_serving_from_arrays(payload, device=device)

    def serve(mus, hook=None):
        return rom.solve_batch(mus, mode="probes")
    return rom, serve


# ----------------------------------------------------------------------
# One run
# ----------------------------------------------------------------------
def run_cell(name, work, config, mix, seed, seconds, trace, device,
             t_launch, root=HERE, spec=None):
    """One run of cell ``name`` on ``device``: the result dict."""
    import numpy as np
    import torch

    from . import harness
    from .trace import breakdown
    from .traffic.artifacts import draw_payload
    from .traffic.generator import Traffic

    root = Path(root)
    if spec is None:
        spec = harness.load_json(root.parent / "BENCHMARK.json")
    e2e, layer = harness.cell_metrics(spec, name)
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    marks = [("imports", time.perf_counter())]
    payload = draw_payload(config, seed, device)
    marks.append(("artifacts", time.perf_counter()))
    rom, serve = build_system(config, payload, device)
    marks.append(("load", time.perf_counter()))
    traffic = Traffic(mix, config["mu_box"], seed)
    for k, batch in enumerate(traffic.warm()):
        t0 = time.perf_counter()
        serve(traffic.as_dicts(batch))
        warm_wall = time.perf_counter() - t0
        marks.append((f"warm{k}", time.perf_counter()))
    # The batches of the calls the window is expected to make, from the
    # last warm-up call's wall, with room; any further one is drawn when
    # the window reaches it, the same either way.
    ahead = int(np.ceil(1.25 * seconds / max(warm_wall, 1e-3))) + 2
    calls = harness.Calls(traffic, payload, work["check"]["keep_per_call"],
                          seed, ahead)
    sync()
    setup_s = time.perf_counter() - t_launch
    marks.append(("pool", t_launch + setup_s))
    prev = t_launch
    parts = []
    for label, t in marks:
        parts.append(f"{label} {t - prev:.3f}")
        prev = t
    print("setup_s parts: " + ", ".join(parts), file=sys.stderr)

    fleet = config["kind"] == "fleet"
    window = harness.Window(
        serve, traffic, calls, seconds, spans=bool(trace) and fleet,
        profile=(1, int(work["profile_calls"])) if trace else None,
        launches=(harness.sweep_bounds(config, mix, payload) if trace
                  else None)).run()
    sync()
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0

    units = {m["name"]: m["unit"] for m in e2e + layer}
    metrics = {}
    if not trace:
        values = {"setup_s": setup_s, "mu_per_s": window.mu_per_s(),
                  "call_p95_ms": window.call_p95_ms()}
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": units[m["name"]]}
    tr = window.trace
    tr.calls = window.calls
    tr.profiled_calls = int(work["profile_calls"]) if trace else 0
    if trace:
        for m in layer:
            value = harness.load_metric(m["name"], root)(tr)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": units[m["name"]]}
    device_info = {
        "platform": "gpu" if cuda else torch.device(device).type,
        "kind": (torch.cuda.get_device_name(torch.device(device))
                 if cuda else "cpu"),
        "count": int(work["chips"]),
        "memory_peak_bytes": peak,
    }
    if trace:
        device_info["busy_s"] = tr.device_busy_us() * 1e-6
        device_info["window_s"] = (tr.window[1] - tr.window[0]) * 1e-6

    # The program's state goes before the reference runs.
    kept, failed = window.kept, window.failed
    attempted = window.attempted_mu()
    del rom, serve, window
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    correct, checks = harness.check(kept, payload, config, work, seed,
                                    device, failed)
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics,
              "device": device_info}
    if trace:
        result["breakdown"] = breakdown(tr)
    result["checks"] = checks
    return result


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None):
    t_launch = process_start()
    args = parse(argv)
    configure_environment(HERE.parent)
    import torch

    from . import harness

    work, config, mix = harness.load_cell(args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(work["chips"])):
        print(f"{args.workload} needs {work['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, work, config, mix, args.seed,
                      args.seconds, args.trace, "cuda", t_launch)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
