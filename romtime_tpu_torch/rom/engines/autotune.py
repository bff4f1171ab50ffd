"""Measured matrices-vs-θ autotune with persisted decisions (counterpart
of ``romtime_tpu/rom/engines/autotune.py``).

The static precompute budget only approximates the crossover between
materializing the operator time tables (K2 per window, or K4) and the
θ-streaming kernels (K1 or K3, or K5). :meth:`autotune_online_precompute`
serves one batch on each variant, pins the faster as the override that
``PrecomputePolicy.precompute_choice`` consults (still bounded by the
hard cap) and persists the measurement under the reference's key and
record, so each package reads the other's file. The reference times
chained, perturbed sweeps because its TPU runtime is lazy; here each call
is timed between two synchronizations of the card.
"""

import json
import os
import statistics
import time

import torch

from ...dtypes import compute_dtype

VARIANTS = ("matrices", "thetas")
TUNED_ENGINES = ("pallas", "windowed-pallas")


def _platform(device):
    """The key's platform token, as ``jax.default_backend()`` names it."""
    return "gpu" if device.type == "cuda" else device.type


class AutotuneMixin:
    AUTOTUNE_PATH = ".romtime_autotune.json"

    def _autotune_key(self, engine, mode, B):
        if engine.startswith("windowed") and self.windows is not None:
            N = self.windows.N
        elif self.global_serving is not None:
            N = self.global_serving.N
        else:
            raise ValueError(f"no serving configuration for {engine!r}")
        nt = int(self.fom.domain[self.fom.NT])
        dtype = str(compute_dtype()).rsplit(".", 1)[-1]
        return (f"{_platform(self.device)}|{engine}|{mode}|N{N}|B{B}"
                f"|nt{nt}|{dtype}")

    def _set_precompute_override(self, winner):
        """Pin ``winner`` (None: the static budget). The routing reads it
        on every call; the cached constant tables serve both routes."""
        self._precompute_override = winner

    def _synchronize(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def autotune_online_precompute(self, mus, mode="probes", engine=None,
                                   n_rep=3, path=None, store=True):
        """Serve ``mus`` on each variant (one warm-up call, then ``n_rep``
        synchronized calls of prep + sweep; the median is its wall), pin
        the faster and, with ``store``, persist the record keyed by
        (platform, engine, mode, N, B, nt, dtype) in ``path``. Returns the
        record with its key. A variant that raises restores the previous
        override."""
        B = len(mus)
        if engine is None:
            engine = self._resolve_engine(mode, B)
        if engine not in TUNED_ENGINES:
            raise NotImplementedError(
                f"autotune runs on the ported table-driven engines "
                f"{TUNED_ENGINES}, not {engine!r}")
        key = self._autotune_key(engine, mode, B)
        previous = self._precompute_override
        walls = {}
        try:
            for variant in VARIANTS:
                self._set_precompute_override(variant)
                self._serve(mus, engine)
                times = []
                for _ in range(n_rep):
                    self._synchronize()
                    t0 = time.perf_counter()
                    self._serve(mus, engine)
                    self._synchronize()
                    times.append(time.perf_counter() - t0)
                walls[variant] = statistics.median(times)
        except BaseException:
            self._set_precompute_override(previous)
            raise
        winner = min(walls, key=walls.get)
        self._set_precompute_override(winner)
        record = {"winner": winner, "wall_s": walls}
        if store:
            path = path or self.AUTOTUNE_PATH
            table = {}
            if os.path.exists(path):
                with open(path) as f:
                    table = json.load(f)
            table[key] = record
            with open(path, "w") as f:
                json.dump(table, f, indent=1, sort_keys=True)
        return dict(record, key=key)

    def load_autotune(self, B, mode="probes", engine=None, path=None):
        """Pin a measured winner for this serving configuration at batch
        ``B``; returns the record, or None when it was never measured."""
        path = path or self.AUTOTUNE_PATH
        if not os.path.exists(path):
            return None
        if engine is None:
            engine = self._resolve_engine(mode, B)
        with open(path) as f:
            table = json.load(f)
        record = table.get(self._autotune_key(engine, mode, B))
        if (record is not None
                and self._precompute_override != record["winner"]):
            self._set_precompute_override(record["winner"])
        return record
