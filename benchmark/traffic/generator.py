"""The one traffic generator: μ batches of a mix file (``mixes/*.json``)
for one closed-loop client, drawn from ``--seed``: call i's batch from
its own stream of the seed, so a run draws the batches it expects before
the window and any further ones as the window needs them, the same
either way.

A mix gives the batch size (``batch``), the μ region (``region``:
``{"kind": "box"}``, uniform over the configuration's box, or
``{"kind": "mach_band", "band": b, "bands": n}``, uniform over the box
restricted by rejection to Mach band b of n equal-width bands) and the
warm-up calls (``warm_calls``); :func:`load_mix` refuses any other key.
Every seed gets the same batch size and the same region: seeds change
the μ, not the work.
"""

import json
from pathlib import Path

import numpy as np

from ..reference.mach import band_edges, band_of, mach
from .artifacts import stream_seed

MIXES = Path(__file__).resolve().parent / "mixes"
#: The varying μ parameters; the box's other names are fixed values.
VARYING = ("a0", "omega", "delta")
WINDOW_STREAM, WARM_STREAM, SAMPLE_STREAM = 2, 3, 4


#: The keys a mix may give; the harness implements no other.
MIX_KEYS = {"batch", "region", "warm_calls"}


def load_mix(name, root=None):
    path = (Path(root) if root else MIXES) / f"{name}.json"
    mix = json.loads(path.read_text())
    unknown = set(mix) - MIX_KEYS
    if unknown:
        raise ValueError(f"mix {name!r}: no generator implements "
                         f"{', '.join(sorted(unknown))}")
    return mix


def _uniform(rng, box, n):
    return {k: rng.uniform(box[k][0], box[k][1], size=n) for k in VARYING}


def draw_mus(mix, box, n, rng):
    """n μ of the mix's region: name → (n,) float64 arrays."""
    region = mix["region"]
    if region["kind"] == "box":
        return _uniform(rng, box, n)
    if region["kind"] != "mach_band":
        raise ValueError(f"unknown μ region {region['kind']!r}")
    edges = band_edges(box, region["bands"])
    got = {k: [] for k in VARYING}
    have = 0
    while have < n:
        cand = _uniform(rng, box, 2 * (n - have) + 64)
        keep = band_of(edges, mach(cand["a0"], cand["omega"],
                                   cand["delta"])) == region["band"]
        for k in VARYING:
            got[k].append(cand[k][keep])
        have += int(keep.sum())
    return {k: np.concatenate(v)[:n] for k, v in got.items()}


class Traffic:
    """The batches of one run: ``batch(i)`` the window's call i,
    ``warm()`` the warm-up batches, each name → (B,) float64 arrays, and
    ``as_dicts`` to turn one into the entry's list of μ dicts (the box's
    fixed parameters added)."""

    def __init__(self, mix, box, seed):
        self.mix, self.box = mix, box
        self.size = int(mix["batch"])
        self.seed = seed
        self.fixed = {k: float(lo) for k, (lo, hi) in box.items()
                      if k not in VARYING}

    def _draw(self, *stream):
        rng = np.random.default_rng(stream_seed(self.seed, *stream))
        return draw_mus(self.mix, self.box, self.size, rng)

    def batch(self, i):
        return self._draw(WINDOW_STREAM, i)

    def warm(self):
        return [self._draw(WARM_STREAM, i)
                for i in range(int(self.mix.get("warm_calls", 2)))]

    def as_dicts(self, batch):
        cols = [batch[k].tolist() for k in VARYING]
        fixed = self.fixed
        return [dict(zip(VARYING, vals), **fixed) for vals in zip(*cols)]
