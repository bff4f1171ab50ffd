"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. the card's name and power limit (nvidia-smi);
2. build of every kernel of the serving path (K1,
   romtime_tpu_torch/csrc/windowed_fused.cu) with nvcc for sm_90a;
3. kernel phase: K1 against its plain PyTorch twin, both on the card, at
   the fleet's two serving shapes (50 windows × 30 steps at N=32, 150 × 10
   at N=48; B=2048; paired LU G=5 "sub1"), errors against
   5e-5·scale, and the kernel's and the twin's ms per sweep;
4. serving phase: ``solve_batch(mus, mode="probes", probe_reduce="mean")``
   on the seeded synthetic 50x32 cell (real piston FOM, nx=1000,
   nt=1500) for five batches of 2048 μ: the K1 launch counter must rise,
   the outputs must be finite and agree with the same sweep run through
   the twin; solves/s (prep + sweep, synchronized; median of the five)
   beside the card name, and the prep/sweep split.

Prints a JSON line of per-kernel results, then, as the last line,
``{"ok": true, "device": {...}}``. Without a CUDA device it exits
non-zero before printing any result. Imports nothing of JAX.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ATOL_REL = 5e-5      # K1 vs twin, relative to the largest |value|
SHAPES = ((50, 30, 32), (150, 10, 48))   # (W, width, N)
B = 2048
GROUP = 5
KERNEL_REPS = 5
SERVE_REQUESTS = 5


def fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(2)


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean ms per call over ``reps`` calls after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def err_and_scale(got, want):
    scale = max(want.abs().max().item(), 1e-30)
    return (got - want).abs().max().item(), scale


def check(name, got, want):
    err, scale = err_and_scale(got, want)
    ok = err <= ATOL_REL * scale and torch.isfinite(got).all().item()
    print(f"  {name}: max abs err {err:.3e} (scale {scale:.3e}, "
          f"limit {ATOL_REL * scale:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: K1 disagrees with its twin")
    return err


def kernel_phase(k1, kernel_tables, dev, power):
    rows = []
    for W, width, N in SHAPES:
        args, kw = kernel_tables(N, W, width, B, seed=W, device=dev)
        kw.update(paired_lu=GROUP, paired_mode="sub1")
        ms, (p, s) = cuda_ms(
            lambda: k1.online_sweep_windowed_fused(*args, **kw),
            KERNEL_REPS)
        plain_ms, (tp, ts) = cuda_ms(
            lambda: k1.windowed_fused_reference(*args, **kw), 1)
        print(f"K1 {W}x{N} width={width} B={B} G={GROUP} on {power}:")
        err = max(check("probes", p, tp),
                  check("state", s[[0, 2]], ts[[0, 2]]))
        print(f"  kernel {ms:.3f} ms/sweep, twin {plain_ms:.1f} ms/sweep")
        rows.append(dict(shape=f"{W}x{N}", ms=ms, plain_ms=plain_ms,
                         max_abs_err=err))
    return rows


def serving_phase(k1, dev, power):
    from romtime_tpu_torch.rom.engines.policy import windowed_solve_group
    from romtime_tpu_torch.rom.engines.windowed_fused import sweep_inputs
    from romtime_tpu_torch.testing.synthetic import (
        synthetic_cell,
        synthetic_mus,
    )

    t0 = time.perf_counter()
    rom = synthetic_cell(seed=0, device=dev)
    rom.solve_batch(synthetic_mus(128, seed=0), probe_reduce="mean")  # warm
    torch.cuda.synchronize()
    print(f"serving cell 50x32 (nx=1000, nt=1500) ready in "
          f"{time.perf_counter() - t0:.1f} s; pivot check "
          f"{rom._pivot_cert:.3g}")

    # The main path: SERVE_REQUESTS batches of B μ each, one at a time.
    batches = [synthetic_mus(B, seed=1 + r) for r in range(SERVE_REQUESTS)]
    k1.online_sweep_windowed_fused.launches = 0
    times = []
    for mus in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = rom.solve_batch(mus, probe_reduce="mean")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = k1.online_sweep_windowed_fused.launches
    seconds = statistics.median(times)
    print(f"serving: {SERVE_REQUESTS} batches of {B} μ, median "
          f"{seconds * 1e3:.1f} ms per batch (min {min(times) * 1e3:.1f}, "
          f"max {max(times) * 1e3:.1f}) = {B / seconds:.1f} solves/s "
          f"(prep + sweep + fetch, synchronized) on {power}; "
          f"K1 launches {launches}")
    if launches < SERVE_REQUESTS:
        raise AssertionError("the serving path did not launch K1")
    probes, uN = outs["probes"], outs["uN_final"]
    if probes.shape != (B, 2) or uN.shape != (B, rom.N):
        raise AssertionError(f"unexpected output shapes {probes.shape}, "
                             f"{uN.shape}")
    if not (torch.isfinite(torch.as_tensor(probes)).all()
            and torch.isfinite(torch.as_tensor(uN)).all()):
        raise AssertionError("non-finite serving outputs")

    # Where the serving time goes (outside the counted run): the θ prep
    # alone, then the sweep alone on its output.
    t0 = time.perf_counter()
    prepped = rom.prep(mus)
    torch.cuda.synchronize()
    prep_ms = (time.perf_counter() - t0) * 1e3
    group, mode = windowed_solve_group()
    args, kw = sweep_inputs(rom.fom, rom.windows, prepped,
                            rom._windowed_tables(), group, mode)
    sweep_ms, _ = cuda_ms(lambda: k1.online_sweep_windowed_fused(*args, **kw),
                          KERNEL_REPS)
    print(f"serving breakdown: prep {prep_ms:.1f} ms, K1 sweep "
          f"{sweep_ms:.1f} ms, the rest (pivot check, probe mean, fetch) "
          f"{seconds * 1e3 - prep_ms - sweep_ms:.1f} ms")

    # The same batch through the twin, on the card, from the same prep.
    tp, ts = k1.windowed_fused_reference(*args, **kw)
    want_p = tp[:, :2, :].mean(dim=0).T
    want_u = ts[0, :rom.N, :].T
    print("serving vs twin:")
    err = max(check("probes (time mean)", torch.as_tensor(probes, device=dev),
                    want_p),
              check("uN_final", torch.as_tensor(uN, device=dev), want_u))
    return launches, err, dict(
        solves_per_s=B / seconds, serve_ms_median=seconds * 1e3,
        serve_ms_min=min(times) * 1e3, serve_ms_max=max(times) * 1e3,
        prep_ms=prep_ms, sweep_ms=sweep_ms)


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    try:
        from romtime_tpu_torch.ops import windowed_fused as k1
        from romtime_tpu_torch.testing.synthetic import kernel_tables
    except ImportError as exc:
        fail(f"the romtime_tpu_torch package is missing beside "
             f"chip_smoke.py ({exc})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"

    power = card()
    print(power)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    path, seconds, log = k1.build()
    print(f"built {path.name} in {seconds:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())

    with torch.inference_mode():
        rows = kernel_phase(k1, kernel_tables, dev, power)
        launches, serve_err, serving = serving_phase(k1, dev, power)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    main_row = rows[0]
    print(json.dumps({"kernels": [{
        "name": "windowed_fused",
        "route": "cuda",
        "source": "romtime_tpu_torch/csrc/windowed_fused.cu",
        "replaces": "romtime_tpu/ops/pallas_online.py:1303",
        "launches": launches,
        "max_abs_err": max([serve_err] + [r["max_abs_err"] for r in rows]),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
    }], "shapes": rows, "serving": serving, "card": power}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
