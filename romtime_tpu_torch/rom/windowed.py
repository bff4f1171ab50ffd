"""Time-windowed serving artifacts (counterpart of
``romtime_tpu/rom/windowed.py:59-164``).

One ``.npz`` container holds a windowed serving configuration: window
bounds, per-window bases ``Vs``, boundary transfers T_w = V_{w+1}ᵀV_w,
per-operator folded combine tensors, the per-window trilinear tables and
an optional dilation law. ``dump``/``load`` use the reference's keys and
plain ``np.savez``, so each package reads the other's files bit-exactly.
The artifacts stay host-side numpy (float64); the serving engine moves
what it needs onto the device.
"""

from dataclasses import dataclass, field

import numpy as np

from .registration import DilationLaw

_GUARD_KEYS = ("guard_feats", "guard_inv_span", "guard_dref")


def _load_dilation(data, prefix):
    if f"{prefix}dilation_coef" not in data:
        return None
    guard = {k: data[f"{prefix}dilation_{k}"] for k in _GUARD_KEYS
             if f"{prefix}dilation_{k}" in data}
    return DilationLaw.from_payload(
        names=data[f"{prefix}dilation_names"],
        coef=data[f"{prefix}dilation_coef"],
        floor=data[f"{prefix}dilation_floor"],
        **guard,
    )


@dataclass
class WindowedServing:
    """Per-window serving artifacts."""

    bounds: np.ndarray          # (W+1,) step indices; bounds[0]=0, [-1]=nt
    Vs: np.ndarray              # (W, nh, N) per-window bases
    transfers: np.ndarray       # (W-1, N, N)
    combines: dict = field(default_factory=dict)  # name → (W, n_out, k)
    trilinear: np.ndarray = None   # (W, N², N) or None
    dilation: DilationLaw = None

    @property
    def n_windows(self):
        return len(self.Vs)

    @property
    def N(self):
        return self.Vs.shape[2]

    def to_arrays(self):
        """The npz payload: key → numpy array."""
        payload = {
            "bounds": np.asarray(self.bounds),
            "Vs": np.asarray(self.Vs),
            "transfers": np.asarray(self.transfers),
        }
        for name, C in self.combines.items():
            payload[f"combine_{name}"] = np.asarray(C)
        if self.trilinear is not None:
            payload["trilinear"] = np.asarray(self.trilinear)
        if self.dilation is not None:
            for k, v in self.dilation.to_payload().items():
                payload[f"dilation_{k}"] = v
        return payload

    @classmethod
    def from_arrays(cls, data):
        """Inverse of :meth:`to_arrays` on any mapping of arrays (an
        ``np.load`` handle or a plain dict)."""
        keys = list(data.keys())
        return cls(
            bounds=data["bounds"],
            Vs=data["Vs"],
            transfers=data["transfers"],
            combines={k[len("combine_"):]: data[k] for k in keys
                      if k.startswith("combine_")},
            trilinear=data["trilinear"] if "trilinear" in keys else None,
            dilation=_load_dilation({k: data[k] for k in keys
                                     if k.startswith("dilation_")}, ""),
        )

    def dump(self, path):
        np.savez(path, **self.to_arrays())

    @classmethod
    def load(cls, path):
        with np.load(path) as data:
            return cls.from_arrays({k: data[k] for k in data.files})
