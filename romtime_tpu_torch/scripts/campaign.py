"""The card measurement campaign over the bench entry (counterpart of
``scripts/tpu_campaign.sh``): each phase runs ``python -m
romtime_tpu_torch.bench`` in a subprocess under its environment, with a
3000 s limit, and appends one JSON line to the output file
(``build/card_campaign.jsonl``, or ``OUT``/``--out``):
``{"phase": name, "bench": <the entry's last line>}``, ``"bench": null``
where the phase printed none (its standard error is in
``build/bench_<phase>.log``). The default fleet warm-resumes the entry's
default directory (``.bench_torch/``).

    python -m romtime_tpu_torch.scripts.campaign [phase ...]

Phases (default: default lu b4096 autotune throughput, in this order):

- ``default``: the entry at its defaults (the mixed-(W, N) fleet, the
  policy's solve, B=2048);
- ``uniform``: the uniform W=30/N=40 fleet, in its own directory;
- ``lu``: ``ROMTIME_SOLVE_ITERS=0`` (the LU schedule);
- ``b4096``: batch 4096 at the joint point;
- ``autotune``: the measured matrices-vs-θ choice at the headline batch;
- ``throughput``: the small-N global-basis profile, in a throwaway
  directory;
- ``device``: a cold build with ``BENCH_OFFLINE=device`` (the card's
  float32 training sweeps), in its own directory: check its
  ``rel_l2_vs_fom`` before trusting a device-built fleet.
"""

import argparse
import json
import os
import subprocess
import sys

#: phase → its environment (scripts/tpu_campaign.sh:40-52).
PHASES = {
    "default": {},
    "uniform": {"BENCH_CELL_WN": "30x40,30x40,30x40,30x40",
                "BENCH_WINDOWS": "30", "BENCH_WINDOW_N": "40",
                "BENCH_DIR": ".bench_uniform_f64"},
    "lu": {"ROMTIME_SOLVE_ITERS": "0"},
    "b4096": {"BENCH_ONLINE_MU": "4096"},
    "autotune": {"BENCH_AUTOTUNE": "1"},
    "throughput": {"BENCH_PROFILE": "throughput", "BENCH_DIR": "tmp"},
    "device": {"BENCH_OFFLINE": "device", "BENCH_COLD": "1",
               "BENCH_DIR": ".bench_device"},
}
#: The phases run when none is named (scripts/tpu_campaign.sh:27).
DEFAULT_PHASES = ("default", "lu", "b4096", "autotune", "throughput")
#: Each phase's limit in seconds (scripts/tpu_campaign.sh:32).
TIMEOUT_S = 3000
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_entry(env, log_path):
    """The entry in a subprocess from the repository's root under
    ``env``, its standard error into ``log_path``; returns its standard
    output ("" where it failed or ran out of time)."""
    with open(log_path, "w") as err:
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "romtime_tpu_torch.bench"], env=env,
                cwd=REPO, stdout=subprocess.PIPE, stderr=err, text=True,
                timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired as exc:
            err.write(f"\nphase ran out of its {TIMEOUT_S} s\n")
            out = exc.stdout or ""
            return out if isinstance(out, str) else out.decode()
    return proc.stdout


def run_phase(name, out_path, log_dir, runner=run_entry, base_env=None):
    """One phase: the entry under the phase's environment, its last line
    appended to ``out_path`` as ``{"phase": name, "bench": ...}``.
    Returns the record."""
    env = dict(os.environ if base_env is None else base_env, **PHASES[name])
    print(f"=== phase: {name} ===", file=sys.stderr, flush=True)
    lines = runner(env, os.path.join(log_dir, f"bench_{name}.log"))
    lines = [ln for ln in (lines or "").splitlines() if ln.strip()]
    try:
        bench = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        bench = None
    record = {"phase": name, "bench": bench}
    with open(out_path, "a") as f:
        f.write(json.dumps(record) + "\n")
    if bench is None:
        print(f"phase {name} FAILED — see {log_dir}/bench_{name}.log",
              file=sys.stderr)
    else:
        print(lines[-1][:400], file=sys.stderr)
    return record


def main(argv=None, runner=run_entry):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("phases", nargs="*", help=", ".join(PHASES))
    parser.add_argument("--out", default=os.environ.get(
        "OUT", os.path.join(REPO, "build", "card_campaign.jsonl")))
    args = parser.parse_args(argv)
    unknown = [p for p in args.phases if p not in PHASES]
    if unknown:
        parser.error(f"unknown phase(s) {unknown}; the phases: "
                     f"{', '.join(PHASES)}")
    log_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(log_dir, exist_ok=True)
    records = [run_phase(name, args.out, log_dir, runner)
               for name in (args.phases or DEFAULT_PHASES)]
    print(f"campaign done -> {args.out}", file=sys.stderr)
    return records


if __name__ == "__main__":
    main()
