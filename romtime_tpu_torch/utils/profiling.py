"""Phase timers and device timing (counterpart of
``romtime_tpu/utils/profiling.py``): wall-clock timers around pipeline
stages, a synchronized timing of a callable (CUDA events on the card, the
host clock on the CPU) and a ``torch.profiler`` trace in place of the
reference's ``jax_trace``."""

import contextlib
import time
from collections import defaultdict

import torch


class PhaseTimer:
    """Accumulating wall-clock timer for named pipeline phases.

    >>> timer = PhaseTimer()
    >>> with timer("offline/pod"):
    ...     ...
    >>> timer.summary()
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self):
        return {name: dict(total_s=round(self.totals[name], 4),
                           calls=self.counts[name])
                for name in sorted(self.totals)}

    def report(self):
        return "\n".join(
            f"{name:<40s} {info['total_s']:>10.3f}s x{info['calls']}"
            for name, info in self.summary().items())


@contextlib.contextmanager
def torch_trace(log_dir):
    """A ``torch.profiler`` trace of the block (CPU and, where there is a
    card, CUDA activity), written to ``log_dir`` as a Chrome trace;
    inspect it with Perfetto or TensorBoard."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(log_dir))) as prof:
        yield prof


def _cuda_device(out):
    """The CUDA device of the first tensor in ``out`` (a tensor or a
    nest of dicts, lists and tuples), else None."""
    if torch.is_tensor(out):
        return out.device if out.is_cuda else None
    items = out.values() if isinstance(out, dict) else (
        out if isinstance(out, (list, tuple)) else ())
    for item in items:
        dev = _cuda_device(item)
        if dev is not None:
            return dev
    return None


def block_and_time(fn, *args, repeats=1, **kwargs):
    """(seconds per call, last output) of ``fn(*args, **kwargs)`` after
    one warm-up call: CUDA events around the ``repeats`` calls where the
    warm-up's output lies on a card (read after the events' end is
    reached), else the host clock (CPU work is done when the call
    returns)."""
    out = fn(*args, **kwargs)
    device = _cuda_device(out)
    if device is not None:
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        stream = torch.cuda.current_stream(device)
        start.record(stream)
        for _ in range(repeats):
            out = fn(*args, **kwargs)
        end.record(stream)
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / repeats, out
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn(*args, **kwargs)
    return (time.perf_counter() - t0) / repeats, out
