"""Phase registration (counterpart of ``romtime_tpu/rom/registration.py``):
the law, its evaluation and guard, and its fitting.

Phase-aligned serving integrates each μ lane on its own dilated clock
t_k = (k+1)·d(μ)·dt, with d(μ) an affine law in power-product features
of μ. The law and its extrapolation guard travel in the windowed serving
npz (``dilation_*`` keys).

The fit (:func:`fit_dilation_law`) runs on the host in float64 numpy, as
the reference's does: a scalar dilation per training trajectory by grid
search against an anchor (:func:`optimal_dilation`), then a least-squares
law over a feature set picked by leave-one-out rms, normalized so its
minimum over the training μ is 1 + margin, with the guard's normalized
training cloud and fill distance. :func:`resample_to_standard` maps a
served trajectory from its dilated clock back to the standard one.
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


def resample_time(u, d, nt=None):
    """``u`` (..., nt) linearly resampled at dilated steps, out[..., k] =
    u(d·k) on the 0-based column clock (reference ``:166-178``)."""
    u = np.asarray(u)
    nt_src = u.shape[-1]
    nt = nt_src if nt is None else int(nt)
    tau = np.clip(d * np.arange(nt), 0, nt_src - 1)
    i0 = np.floor(tau).astype(int)
    fr = tau - i0
    i1 = np.minimum(i0 + 1, nt_src - 1)
    return u[..., i0] * (1 - fr) + u[..., i1] * fr


def optimal_dilation(u, anchor, lo=0.9, hi=1.1, coarse=161, refine=33,
                     stride=8):
    """The scalar d minimizing ‖u(:, d·t) − anchor‖_F: a ``coarse`` grid
    over [lo, hi], then ``refine`` points over the best cell's two
    neighbours, on every ``stride``-th row (reference ``:180-205``)."""
    u = np.asarray(u, np.float64)[::max(int(stride), 1)]
    anchor = np.asarray(anchor, np.float64)[::max(int(stride), 1)]

    def err(d):
        return float(np.linalg.norm(resample_time(u, d) - anchor))

    grid = np.linspace(lo, hi, coarse)
    d0 = grid[int(np.argmin([err(d) for d in grid]))]
    step = grid[1] - grid[0]
    fine = np.linspace(d0 - step, d0 + step, refine)
    return float(fine[int(np.argmin([err(d) for d in fine]))])


#: Feature sets of ``fit_dilation_law(features="auto")``, ranked by
#: leave-one-out rms (reference ``:208-218``): linear, linear with the
#: piston Mach number, quadratic.
FEATURE_CANDIDATES = (
    ("a0", "omega", "delta"),
    ("a0", "omega", "delta", "delta*omega*a0^-1"),
    ("a0", "omega", "delta", "a0^2", "omega^2", "a0*omega"),
)


def _design_matrix(mus, names):
    return np.stack(
        [np.ones(len(mus))]
        + [np.array([float(_feature_value(m, n)) for m in mus])
           for n in names],
        axis=1)


def _loo_rms(X, y):
    """Leave-one-out rms of the least-squares fit, by direct refits."""
    errs = []
    for j in range(len(y)):
        m = np.ones(len(y), bool)
        m[j] = False
        cj, *_ = np.linalg.lstsq(X[m], y[m], rcond=None)
        errs.append(X[j] @ cj - y[j])
    return float(np.sqrt(np.mean(np.square(errs))))


def fit_dilation_law(snapshots, mus, features="auto", anchor=0, margin=0.01,
                     search=(0.82, 1.22)):
    """A cell's dilation law from its standard-clock training
    trajectories (reference ``:240-320``).

    ``snapshots`` (nh, nt) arrays and their μ dicts; ``features`` "auto"
    (the :data:`FEATURE_CANDIDATES` set of least leave-one-out rms among
    those with at least two points per coefficient, else the linear set)
    or a tuple of feature strings; ``anchor`` the alignment anchor's
    index; ``margin`` the headroom of the normalization (the least
    training dilation is 1 + margin). Returns ``(law, dils)``, the law and
    the normalized training dilations to re-solve the cell at. Raises
    ``ValueError`` where a search lands on the boundary of ``search``: the
    cell does not phase-align under a scalar dilation."""
    anchor_traj = np.asarray(snapshots[anchor], np.float64)
    lo, hi = search
    dils = []
    for j, s in enumerate(snapshots):
        if j == anchor:
            dils.append(1.0)
            continue
        d = optimal_dilation(s, anchor_traj, lo=lo, hi=hi)
        if d <= lo + 1e-9 or d >= hi - 1e-9:
            raise ValueError(
                f"dilation search for trajectory {j} hit the boundary "
                f"({d:.4f} of [{lo}, {hi}]) — the cell does not "
                "phase-align under a scalar time dilation")
        dils.append(d)
    dils = np.asarray(dils, np.float64)

    if features == "auto":
        best = None
        for cand in FEATURE_CANDIDATES:
            if len(dils) < 2 * (len(cand) + 1):
                continue
            rms = _loo_rms(_design_matrix(mus, cand), dils)
            if best is None or rms < best[0]:
                best = (rms, cand)
        names = FEATURE_CANDIDATES[0] if best is None else best[1]
    else:
        names = tuple(features)

    X = _design_matrix(mus, names)
    coef, *_ = np.linalg.lstsq(X, dils, rcond=None)
    pred = X @ coef
    scale = (1.0 + margin) / float(pred.min())
    coef = coef * scale
    # The guard: the range-normalized training feature cloud and its fill
    # distance (at least 3 training μ).
    feats = X[:, 1:]
    guard = {}
    if len(mus) >= 3 and feats.shape[1]:
        span = feats.max(axis=0) - feats.min(axis=0)
        inv_span = np.where(span > 0, 1.0 / np.where(span > 0, span, 1.0),
                            1.0)
        G = feats * inv_span
        d2 = ((G[:, None, :] - G[None, :, :]) ** 2).sum(axis=-1)
        np.fill_diagonal(d2, np.inf)
        dref = float(np.sqrt(d2.min(axis=1)).max())
        if np.isfinite(dref) and dref > 0:
            guard = dict(guard_feats=G, guard_inv_span=inv_span,
                         guard_dref=dref)
    law = DilationLaw(names=tuple(names), coef=coef, floor=1.0, **guard)
    return law, pred * scale


def resample_to_standard(traj, d, axis=0):
    """A trajectory sampled at t = (k+1)·d·dt along ``axis`` mapped to
    t = (m+1)·dt by cubic Lagrange interpolation on the uniform source
    grid (reference ``:323-377``); the identity at d = 1. The map is
    linear, so resampling a served lane and its matched-grid reference
    alike measures the reduction error on the standard clock."""
    if abs(float(d) - 1.0) < 1e-12:
        return np.asarray(traj)
    traj = np.moveaxis(np.asarray(traj), axis, 0)
    nt = traj.shape[0]
    s = np.arange(1, nt + 1) / float(d)
    j0 = np.clip(np.floor(s).astype(int), 2, nt - 2)
    r = s - j0
    w = np.stack([
        -r * (r - 1) * (r - 2) / 6.0,
        (r + 1) * (r - 1) * (r - 2) / 2.0,
        -(r + 1) * r * (r - 2) / 2.0,
        (r + 1) * r * (r - 1) / 6.0,
    ])  # stencil offsets -1, 0, 1, 2 around j0
    w = w.reshape((4, nt) + (1,) * (traj.ndim - 1))
    i = j0 - 1
    out = (w[0] * traj[i - 1] + w[1] * traj[i]
           + w[2] * traj[i + 1] + w[3] * traj[i + 2])
    return np.moveaxis(out, 0, axis)
