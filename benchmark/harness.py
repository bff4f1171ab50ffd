"""The harness of one run, apart from the system under test: the files of
a cell found by name, the closed-loop window, the traced calls, the
per-layer metrics and the check of the served rows against the plain
reference. :mod:`benchmark.run` hands it the system as a ``serve``
callable; nothing here imports the program.
"""

import importlib.util
import json
import statistics
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from .reference import compare
from .reference.sweep import cell_of
from .roofline import bounds
from .trace import (
    CALL_SPAN,
    CELL_SPAN,
    Trace,
    profiled_window,
    read_chrome_trace,
)
from .traffic.artifacts import stream_seed
from .traffic.generator import SAMPLE_STREAM, load_mix

HERE = Path(__file__).resolve().parent
CHECK_STREAM = 5


# ----------------------------------------------------------------------
# Files found by name
# ----------------------------------------------------------------------
def load_json(path):
    return json.loads(Path(path).read_text())


def load_cell(name, root=HERE):
    """(workload, config, mix) of cell ``name``: ``workloads/<name>.json``,
    the configuration it names (``configs/<config>.json``) and its
    traffic mix (``traffic/mixes/<traffic>.json``)."""
    root = Path(root)
    path = root / "workloads" / f"{name}.json"
    if not path.exists():
        raise SystemExit(f"unknown workload {name!r}: no {path}")
    work = load_json(path)
    config = load_json(root / "configs" / f"{work['config']}.json")
    mix = load_mix(work["traffic"], root / "traffic" / "mixes")
    return work, config, mix


def cell_metrics(spec, name):
    """The end-to-end and per-layer metric entries of ``BENCHMARK.json``
    (``spec``) that cell ``name`` reports: those whose ``workloads`` list
    it, or, without the key, every cell that reports the metric they
    move."""
    def listed(m):
        return "workloads" not in m or name in m["workloads"]

    e2e = [m for m in spec["end_to_end"] if listed(m)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if name in m.get("workloads", [])
             or ("workloads" not in m and m["moves"] in moved)]
    return e2e, layer


def load_metric(name, root=HERE):
    """The reader ``read(trace)`` of ``metrics/<name>.py``."""
    path = Path(root) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


# ----------------------------------------------------------------------
# Rows kept for the check
# ----------------------------------------------------------------------
def keep_rows(payload, batch, per_group, seed, i):
    """The rows of call i's batch kept for the check: in each occupied
    cell (the whole batch is one group on a global ROM) its first and its
    last row, lanes 0 and n−1 of the cell's sub-batch, on either side of
    which the router's padding begins, and ``per_group`` more drawn from
    the seed among the rest; (rows, each row's cell)."""
    rng = np.random.default_rng(stream_seed(seed, SAMPLE_STREAM, i))
    groups = cell_of(payload, batch)
    rows = []
    for c in np.unique(groups):
        idx = np.nonzero(groups == c)[0]
        inner = idx[1:-1]
        take = min(per_group, len(inner))
        rows.extend({int(idx[0]), int(idx[-1])})
        rows.extend(rng.choice(inner, size=take, replace=False).tolist())
    rows = np.sort(np.asarray(rows, np.int64))
    return rows, groups[rows]


class Calls:
    """Call i's batch and kept rows: those of the calls a window is
    expected to make drawn before it (``ahead``), any further ones when
    the window reaches them, the same either way."""

    def __init__(self, traffic, payload, per_group, seed, ahead):
        self.traffic, self.payload = traffic, payload
        self.per_group, self.seed = per_group, seed
        self.drawn = [self._draw(i) for i in range(ahead)]

    def _draw(self, i):
        batch = self.traffic.batch(i)
        return (batch,) + keep_rows(self.payload, batch, self.per_group,
                                    self.seed, i)

    def __getitem__(self, i):
        return self.drawn[i] if i < len(self.drawn) else self._draw(i)


class Kept:
    """The kept rows of the finished calls: μ, cell, served probes, final
    state and, where served, dilation and guard flag."""

    def __init__(self):
        self.mu, self.groups, self.probes, self.uN = [], [], [], []
        self.oor = []

    def add(self, batch, rows, groups, out):
        self.mu.append({k: np.asarray(v)[rows] for k, v in batch.items()})
        self.groups.append(groups)
        self.probes.extend(np.asarray(out["probes"])[rows])
        uN = out["uN_final"]
        self.uN.extend([np.asarray(uN[int(i)]) for i in rows])
        oor = out.get("dil_oor")
        self.oor.extend(np.zeros(len(rows)) if oor is None
                        else np.asarray(oor)[rows])

    def sample(self, per_group, seed):
        """Up to ``per_group`` kept rows of each cell, drawn from the
        seed: (μ name → (n,), cells (n,), indices into the kept rows)."""
        groups = np.concatenate(self.groups)
        mu = {k: np.concatenate([m[k] for m in self.mu])
              for k in self.mu[0]}
        rng = np.random.default_rng(stream_seed(seed, CHECK_STREAM))
        pick = []
        for c in np.unique(groups):
            idx = np.nonzero(groups == c)[0]
            take = min(per_group, len(idx))
            pick.extend(rng.choice(idx, size=take, replace=False).tolist())
        pick = np.sort(np.asarray(pick, np.int64))
        return {k: v[pick] for k, v in mu.items()}, groups[pick], pick

    def served(self, pick):
        """The served outputs of kept rows ``pick``, as the comparison
        takes them."""
        return {"probes": [self.probes[i] for i in pick],
                "uN_final": [self.uN[i] for i in pick],
                "dil_oor": np.asarray(self.oor)[pick]}


# ----------------------------------------------------------------------
# The window
# ----------------------------------------------------------------------
def finite_rows(out, n):
    """Rows whose last probes are finite (a row that went non-finite at
    any step stays so through the solves that follow)."""
    last = np.asarray(out["probes"])[:, -1, :]
    if last.shape[0] != n:
        return np.zeros(n, bool)
    return np.isfinite(last).all(axis=1)


class Window:
    """One closed-loop client calling ``serve`` back to back on the
    batches of ``calls`` (:class:`Calls`) for ``seconds``; with
    ``profile`` = (first call, count) the profiler records ``count``
    calls after one warm-up call, and the window lasts until they are
    done."""

    def __init__(self, serve, traffic, calls, seconds, spans=False,
                 profile=None, launches=None):
        self.serve, self.traffic = serve, traffic
        self.batches, self.seconds = calls, seconds
        self.spans, self.profile = spans, profile
        self.launches = launches
        self.calls, self.kept = [], Kept()
        self.failed = 0
        self.trace = Trace()

    def _profiler(self):
        first, count = self.profile
        sched = torch.profiler.schedule(wait=0, warmup=1, active=count,
                                        repeat=1)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return first, count, torch.profiler.profile(activities=acts,
                                                    schedule=sched)

    def run(self):
        prof, first, count = None, None, 0
        if self.profile:
            first, count, prof = self._profiler()
        start = time.perf_counter()
        last = start
        i = 0
        # A traced window runs on until its profiled calls are done.
        while (time.perf_counter() - start < self.seconds
               or prof is not None):
            if prof is not None and i == first:
                prof.start()
            profiled = prof is not None and first < i <= first + count
            self._call(i, profiled)
            last = time.perf_counter()
            if prof is not None and first <= i <= first + count:
                prof.step()
                if i == first + count:
                    prof.stop()
                    self._read_profile(prof)
                    prof = None
            i += 1
        self.start, self.last = start, last
        return self

    def _call(self, i, profiled):
        batch, rows, groups = self.batches[i]
        mus = self.traffic.as_dicts(batch)
        n = len(mus)
        cells = []

        def hook(run_cell):
            def timed(sub):
                t0 = time.perf_counter()
                with torch.profiler.record_function(CELL_SPAN):
                    out = run_cell(sub)
                cells.append((len(sub), time.perf_counter() - t0))
                return out
            return timed

        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(CALL_SPAN):
                out = self.serve(mus, hook if self.spans else None)
        except Exception:                       # counted, reported, kept on
            traceback.print_exc(file=sys.stderr)
            out = None
        wall = time.perf_counter() - t0
        call = {"wall_s": wall, "mu": n, "profiled": profiled}
        if self.spans:
            call["cells"] = cells
        self.calls.append(call)
        if out is None:
            self.failed += n
            return
        ok = finite_rows(out, n)
        self.failed += int(n - ok.sum())
        self.kept.add(batch, rows, groups, out)
        if profiled and self.launches is not None:
            self.trace.launches.extend(self.launches(batch))

    def _read_profile(self, prof):
        device, host = read_chrome_trace(prof)
        window = profiled_window(host)
        self.trace.device = [e for e in device
                             if e[2] + e[3] >= window[0] and e[2] <= window[1]]
        self.trace.host = [e for e in host
                           if e[2] + e[3] >= window[0] and e[2] <= window[1]]
        self.trace.window = window

    # End-to-end metrics ------------------------------------------------
    def attempted_mu(self):
        return sum(c["mu"] for c in self.calls)

    def mu_per_s(self):
        """μ served (attempted, less failed) over the time from the
        window's start to the last completion."""
        return (self.attempted_mu() - self.failed) / (self.last - self.start)

    def call_p95_ms(self):
        walls = [c["wall_s"] * 1e3 for c in self.calls]
        if len(walls) < 2:
            return walls[0] if walls else None
        return statistics.quantiles(walls, n=20, method="inclusive")[18]


def sweep_bounds(config, mix, payload):
    """``launches(batch)``: the sweep launches of one call, (role, least
    seconds) each, from the cell's shapes (:mod:`.roofline.bounds`): one
    K4 sweep on a global ROM, one K1 sweep per occupied cell of a fleet,
    each over the whole batch."""
    fom = config["fom"]
    nt, B = int(fom["nt"]), int(mix["batch"])
    k = config["dofs_per_source"]
    km, kk, kf, p = k, 3 * k, k, 2
    if config["kind"] == "global":
        t = bounds.k4_seconds(nt, config["N"], B, p)[0]
        return lambda batch: [("k4", t)]
    per_cell = [bounds.k1_seconds(nt, W, N, B, km, kk, kf, p)[0]
                for W, N in config["cells"]]

    def launches(batch):
        return [("k1", per_cell[int(c)])
                for c in np.unique(cell_of(payload, batch))]

    return launches


# ----------------------------------------------------------------------
# The check
# ----------------------------------------------------------------------
def check(kept, payload, config, work, seed, device, failed):
    """The numbers compared, each beside its limit, and ``correct``:
    every number within its limit and no failed μ."""
    if not kept.probes:
        return False, {"rows_checked": {"value": 0, "limit": None}}
    mu, groups, pick = kept.sample(work["check"]["rows_per_cell"], seed)
    ref = compare.reference_rows(payload, config, groups, mu,
                                 device=device)
    return verdict(kept.served(pick), ref, config, groups, work, failed)


def verdict(served, ref, config, groups, work, failed=0):
    """(correct, checks) of served rows against the reference's rows of
    the same μ, the rows of ``groups`` (their cells)."""
    registered = np.isin(groups, config.get("registered", []))
    numbers = compare.compare(served, ref, registered)
    ok, checks = compare.judge(numbers, work["check"]["limits"])
    checks["failed_mu"] = {"value": failed, "limit": 0}
    return ok and failed == 0, checks
