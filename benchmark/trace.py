"""What a traced run reads: the benchmark's own spans around each call
and each per-cell sweep, and the device's activity from
``torch.profiler`` over a few calls inside the window, reduced to one
:class:`Trace` that every per-layer metric (``metrics/<name>.py``)
reads.
"""

import json
import os
import re
import tempfile
from dataclasses import dataclass, field

#: Chrome-trace categories of device activity.
KERNEL, MEMCPY, MEMSET = "kernel", "gpu_memcpy", "gpu_memset"
DEVICE_CATS = (KERNEL, MEMCPY, MEMSET)
HOST_CATS = ("cpu_op", "user_annotation")
#: The span names the harness records (``torch.profiler.record_function``).
CALL_SPAN, CELL_SPAN = "bench.call", "bench.cell"

#: The serving body's template, as the profiler names its kernels:
#: ``serving_kernel<NP, CLOCKED, PLAIN, MAT>``.
_SERVING = re.compile(r"serving_kernel<\s*\d+\s*,\s*(\w+)\s*,\s*(\w+)"
                      r"\s*,\s*(\w+)\s*>")
_ROLES = {("false", "false", "false"): "k1", ("false", "true", "true"): "k4"}


def sweep_role(name):
    """"k1" for the serving body's θ-source step (CLOCKED, PLAIN and MAT
    false), "k4" for its plain step over materialized tables (PLAIN and
    MAT true, CLOCKED false), else None (any other kernel)."""
    m = _SERVING.search(name)
    return _ROLES.get(m.groups()) if m else None


@dataclass
class Trace:
    """``calls``: every window call, a dict with ``wall_s``, ``mu``,
    ``profiled`` and (spans on) ``cells``, a list of (lanes, seconds) per
    cell sweep; ``device``: (category, name, start µs, duration µs) of
    every device activity in the profiled span; ``host``: (category,
    name, start µs, duration µs) of the host ops and spans there;
    ``window``: the profiled span (start µs, end µs); ``launches``: the
    sweep launches of the profiled calls, (role, least seconds) each;
    ``profiled_calls``: their number."""

    calls: list = field(default_factory=list)
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    window: tuple = (0.0, 0.0)
    launches: list = field(default_factory=list)
    profiled_calls: int = 0

    def device_busy_us(self):
        """Length of the union of device activity inside the window."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(s + d, hi))
                       for _c, _n, s, d in self.device)
        busy, end = 0.0, lo
        for s, e in spans:
            if e <= end:
                continue
            busy += e - max(s, end)
            end = e
        return busy

    def idle_gaps(self):
        """[(start µs, length µs)] of the window's stretches with no
        device activity."""
        lo, hi = self.window
        gaps, end = [], lo
        for s, d in sorted((s, d) for _c, _n, s, d in self.device):
            if s > end:
                gaps.append((end, s - end))
            end = max(end, s + d)
        if hi > end:
            gaps.append((end, hi - end))
        return gaps

    def host_label(self, t):
        """What the host was doing at ``t`` µs: the innermost host op,
        inside the innermost benchmark span."""
        inner = {}
        for cat, name, s, d in self.host:
            if s <= t <= s + d:
                key = "op" if cat == "cpu_op" else "span"
                if key not in inner or d < inner[key][1]:
                    inner[key] = (name, d)
        op = inner.get("op", ("no op",))[0]
        span = inner.get("span", ("between calls",))[0]
        return f"{op} in {span}"


def read_chrome_trace(prof):
    """(device events, host events) of a finished profiler, through its
    exported Chrome trace (a file under TMPDIR, deleted after)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)
    device, host = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        row = (cat, ev.get("name", ""), float(ev["ts"]),
               float(ev.get("dur", 0.0)))
        if cat in DEVICE_CATS:
            device.append(row)
        elif cat in HOST_CATS:
            host.append(row)
    return device, host


def profiled_window(host):
    """(start µs, end µs) from the first to the last call span."""
    calls = [(s, s + d) for cat, name, s, d in host
             if cat == "user_annotation" and name == CALL_SPAN]
    if not calls:
        raise RuntimeError("the profiler recorded no call span")
    return min(s for s, _e in calls), max(e for _s, e in calls)


def breakdown(trace, top=10, width=160):
    """The device operations that took most time and the longest idle
    gaps by what the host was doing, seconds each."""
    by_name = {}
    lo, hi = trace.window
    for _cat, name, s, d in trace.device:
        if s >= lo and s < hi:
            by_name[name] = by_name.get(name, 0.0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(trace.idle_gaps(), key=lambda g: -g[1])[:top]
    return {"device_ops": [[n[:width], v * 1e-6] for n, v in ops],
            "idle_gaps": [[trace.host_label(s + 0.5 * d)[:width], d * 1e-6]
                          for s, d in gaps]}
