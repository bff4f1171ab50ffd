"""Phase-registration law evaluation, serving subset (counterpart of
``romtime_tpu/rom/registration.py``; the fitting stays in the JAX
package).

Phase-aligned serving integrates each μ lane on its own dilated clock
t_k = (k+1)·d(μ)·dt, with d(μ) an affine law in power-product features
of μ. The law and its extrapolation guard travel in the windowed serving
npz (``dilation_*`` keys).
"""

from dataclasses import dataclass

import numpy as np
import torch


def _feature_value(mu, name):
    """One feature of the law grammar on a μ dict of scalars or (B,)
    tensors: ``"*"``-joined factors ``key`` or ``key^int``, e.g.
    ``"delta*omega*a0^-1"`` (the piston Mach number)."""
    val = None
    for part in name.split("*"):
        if "^" in part:
            key, exp = part.split("^")
            exp = int(exp)
        else:
            key, exp = part, 1
        v = mu[key]
        f = v ** exp if exp >= 0 else 1.0 / (v ** (-exp))
        val = f if val is None else val * f
    return val


#: A lane is flagged as extrapolating when its nearest-training-μ distance
#: (range-normalized feature space) exceeds GUARD_FACTOR × the training
#: fill distance.
GUARD_FACTOR = 1.5


@dataclass
class DilationLaw:
    """d(μ) = c₀ + Σᵢ cᵢ·fᵢ(μ), clamped below at ``floor``; optionally
    with the serve-time extrapolation guard (normalized training feature
    cloud ``guard_feats``, normalizers ``guard_inv_span``, fill distance
    ``guard_dref``)."""

    names: tuple
    coef: np.ndarray
    floor: float = 1.0
    guard_feats: np.ndarray = None
    guard_inv_span: np.ndarray = None
    guard_dref: float = None

    def predict(self, mu):
        """Dilation for a μ dict of scalars or tensors."""
        d = float(self.coef[0])
        for c, n in zip(self.coef[1:], self.names):
            d = d + float(c) * _feature_value(mu, n)
        if isinstance(d, torch.Tensor):
            return d.clamp(min=self.floor)
        return max(float(d), self.floor)

    @property
    def has_guard(self):
        return (self.guard_feats is not None
                and self.guard_dref is not None
                and np.isfinite(self.guard_dref))

    def guard_distance(self, mu):
        """Nearest-training-μ distance in normalized feature space (one
        value per lane); ``None`` without a guard."""
        if not self.has_guard:
            return None
        ref = next(iter(mu.values()))
        feats = [torch.as_tensor(_feature_value(mu, n)) * float(s)
                 for n, s in zip(self.names, self.guard_inv_span)]
        x = torch.stack(feats, dim=-1)
        G = torch.as_tensor(self.guard_feats, dtype=x.dtype,
                            device=torch.as_tensor(ref).device)
        d2 = ((x[..., None, :] - G) ** 2).sum(dim=-1)
        return torch.sqrt(d2.min(dim=-1).values)

    def extrapolation_flag(self, mu, factor=GUARD_FACTOR):
        dist = self.guard_distance(mu)
        if dist is None:
            return None
        return dist > factor * self.guard_dref

    def to_payload(self):
        payload = {
            "names": np.array(list(self.names)),
            "coef": np.asarray(self.coef, np.float64),
            "floor": np.float64(self.floor),
        }
        if self.has_guard:
            payload["guard_feats"] = np.asarray(self.guard_feats, np.float64)
            payload["guard_inv_span"] = np.asarray(self.guard_inv_span,
                                                   np.float64)
            payload["guard_dref"] = np.float64(self.guard_dref)
        return payload

    @classmethod
    def from_payload(cls, names, coef, floor, guard_feats=None,
                     guard_inv_span=None, guard_dref=None):
        return cls(names=tuple(str(n) for n in np.asarray(names)),
                   coef=np.asarray(coef, np.float64),
                   floor=float(floor),
                   guard_feats=(None if guard_feats is None
                                else np.asarray(guard_feats, np.float64)),
                   guard_inv_span=(None if guard_inv_span is None
                                   else np.asarray(guard_inv_span,
                                                   np.float64)),
                   guard_dref=(None if guard_dref is None
                               else float(guard_dref)))
