"""Throttled progress reporting for long offline loops (counterpart of
``romtime_tpu/utils/progress.py``): a stderr line for the first and the
last item and at most every ``min_interval`` seconds between, without a
tqdm dependency. ``ROMTIME_PROGRESS=0`` silences it."""

import os
import sys
import time


def progress(iterable, label="sweep", total=None, min_interval=5.0):
    """Yield from ``iterable``, reporting throttled progress to stderr.

    ``total`` defaults to ``len(iterable)`` where it has one; an
    iterable of unknown length reports counts only."""
    if os.environ.get("ROMTIME_PROGRESS", "1") == "0":
        yield from iterable
        return
    if total is None:
        try:
            total = len(iterable)
        except TypeError:
            total = None
    start = time.time()
    last = 0.0
    for i, item in enumerate(iterable):
        yield item
        now = time.time()
        done = i + 1
        if done == total or now - last >= min_interval:
            last = now
            frac = f"{done}/{total}" if total else str(done)
            rate = (now - start) / done
            eta = ""
            if total and done < total:
                eta = f", eta {rate * (total - done):.0f}s"
            print(f"[{label}] {frac} (+{now - start:.1f}s{eta})",
                  file=sys.stderr, flush=True)
