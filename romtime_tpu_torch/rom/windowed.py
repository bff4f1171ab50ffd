"""Time-windowed serving artifacts and their bases (counterpart of
``romtime_tpu/rom/windowed.py``).

One ``.npz`` container holds a windowed serving configuration: window
bounds, per-window bases ``Vs``, boundary transfers T_w = V_{w+1}ᵀV_w,
per-operator folded combine tensors, the per-window trilinear tables and
an optional dilation law. A μ-local fleet (:class:`MuLocalWindowed`)
holds one such configuration per Mach cell under ``c{c}_`` prefixes.
``dump``/``load`` use the reference's keys and plain ``np.savez``, so
each package reads the other's files bit-exactly. The artifacts stay
host-side numpy (float64); the serving engine moves what it needs onto
the device (and caches it on the configuration object).

The window bases (:func:`build_windowed_basis`) are a direct SVD of each
window's stacked snapshot columns on the host (``rom/pod.py``), float64;
:func:`predict_window_floor` and :func:`select_fleet_shapes` pick a
cell's (W, N) from the σ-tails of the same stacks.
"""

from dataclasses import dataclass, field

import numpy as np

from .pod import orth
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


def leading_modes(C, N, Nh):
    """The N-mode block of an Nh-mode combine (…, n_out, k): its leading
    N×N operator block (n_out = Nh²) or its first N rows (n_out = Nh)."""
    C = np.asarray(C)
    lead, k = C.shape[:-2], C.shape[-1]
    if C.shape[-2] == Nh * Nh:
        C = C.reshape(lead + (Nh, Nh, k))[..., :N, :N, :]
        return np.ascontiguousarray(C.reshape(lead + (N * N, k)))
    return np.ascontiguousarray(C[..., :N, :])


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

    def truncate(self, N):
        """The nested N-mode configuration of an (N+Δ)-mode build by pure
        slicing (reference ``:103-144``): per-window POD bases nest, so
        the first N columns of every artifact are the N-mode build."""
        Nh = self.N
        if N > Nh:
            raise ValueError(f"cannot truncate N={Nh} to {N}")
        if N == Nh:
            return self
        combines = {name: leading_modes(C, N, Nh)
                    for name, C in self.combines.items()}
        tri = None
        if self.trilinear is not None:
            T = np.asarray(self.trilinear)
            W = T.shape[0]
            tri = np.ascontiguousarray(
                T.reshape(W, Nh, Nh, Nh)[:, :N, :N, :N].reshape(W, N * N, N))
        return WindowedServing(
            bounds=np.asarray(self.bounds),
            Vs=np.ascontiguousarray(np.asarray(self.Vs)[:, :, :N]),
            transfers=np.ascontiguousarray(
                np.asarray(self.transfers)[:, :N, :N]),
            combines=combines, trilinear=tri, dilation=self.dilation)


@dataclass
class MuLocalWindowed:
    """μ-local windowed serving (reference ``:298-414``): K Mach-band
    cells, each a :class:`WindowedServing`. A served μ of piston Mach m
    goes to cell ``searchsorted(edges, m, side="right") - 1``, clipped to
    the nearest cell outside the edges. Cells may differ in (W, N).
    ``cells_srom`` are the nested (N+Δ) builds the serving cells were
    sliced from, or None."""

    edges: np.ndarray              # (K+1,) Mach bin edges
    cells: list                    # K × WindowedServing
    cells_srom: list = None        # K × WindowedServing at N+Δ, or None

    @property
    def n_cells(self):
        return len(self.cells)

    @property
    def n_windows(self):
        return self.cells[0].n_windows

    @property
    def N(self):
        return self.cells[0].N

    @property
    def cell_wn(self):
        """Per-cell (n_windows, N) pairs."""
        return [(w.n_windows, w.N) for w in self.cells]

    @property
    def is_uniform(self):
        return len(set(self.cell_wn)) == 1

    def cell_of(self, mach):
        """Cell index (scalar or array) for piston Mach number(s)."""
        idx = np.searchsorted(np.asarray(self.edges), np.asarray(mach),
                              side="right") - 1
        return np.clip(idx, 0, self.n_cells - 1)

    def to_arrays(self):
        """The npz payload. A nested fleet stores only its (N+Δ) cells and
        the per-cell serving N (``serving_ns``); :meth:`from_arrays`
        slices the serving cells back out."""
        payload = {"edges": np.asarray(self.edges)}
        store = self.cells
        if self.cells_srom is not None:
            payload["serving_ns"] = np.asarray([w.N for w in self.cells])
            store = self.cells_srom
        for c, win in enumerate(store):
            payload.update({f"c{c}_{k}": v
                            for k, v in win.to_arrays().items()})
        return payload

    @classmethod
    def from_arrays(cls, data):
        """Inverse of :meth:`to_arrays` on any mapping of arrays; reads
        the legacy uniform ``serving_n`` too."""
        edges = data["edges"]
        cells = []
        for c in range(len(edges) - 1):
            pre = f"c{c}_"
            cells.append(WindowedServing.from_arrays(
                {k[len(pre):]: data[k] for k in data if k.startswith(pre)}))
        if "serving_ns" in data:
            ns = [int(n) for n in np.asarray(data["serving_ns"])]
        elif "serving_n" in data:
            ns = [int(data["serving_n"])] * len(cells)
        else:
            return cls(edges=edges, cells=cells)
        return cls(edges=edges,
                   cells=[w.truncate(n) for w, n in zip(cells, ns)],
                   cells_srom=cells)

    def dump(self, path):
        np.savez(path, **self.to_arrays())

    @classmethod
    def load(cls, path):
        with np.load(path) as data:
            return cls.from_arrays({k: data[k] for k in data.files})


def _window_stacks(snapshots, n_windows, overlap):
    """(bounds, per-window (nh, m) stacks of every trajectory's columns
    [bounds[w] − overlap, bounds[w+1] + overlap) clipped to [0, nt))."""
    snapshots = [np.asarray(s, np.float64) for s in snapshots]
    nt = snapshots[0].shape[1]
    bounds = np.linspace(0, nt, n_windows + 1).astype(int)
    stacks = []
    for w in range(n_windows):
        a = max(0, int(bounds[w]) - overlap)
        b = min(nt, int(bounds[w + 1]) + overlap)
        stacks.append(np.hstack([s[:, a:b] for s in snapshots]))
    return bounds, stacks


def build_windowed_basis(snapshots, n_windows, num_basis, overlap=2,
                         tol_t=None):
    """Per-window POD bases of per-μ (nh, nt) snapshot matrices (reference
    ``:166-208``): W equal windows, each borrowing ``overlap`` columns of
    its neighbours, each basis the first ``num_basis`` left singular
    vectors of the raw stacked window snapshots (no per-μ time stage: its
    drop tolerance would discard the σ/σ₁ ≈ 1e-7…1e-9 directions the
    window floor needs). Raises ``ValueError`` where a window's stack has
    fewer than ``num_basis`` rows or columns. ``tol_t`` is accepted and
    unused, as in the reference. Returns (bounds, Vs (W, nh, N),
    transfers (W−1, N, N) = V_{w+1}ᵀ V_w), float64."""
    bounds, stacks = _window_stacks(snapshots, n_windows, overlap)
    Vs = []
    for w, stacked in enumerate(stacks):
        if min(stacked.shape) < num_basis:
            raise ValueError(
                f"window {w}: snapshot matrix {stacked.shape} has rank "
                f"< num_basis={num_basis} — add training μ or snapshots")
        V, _sig, _en = orth(stacked, num=num_basis, normalize=False)
        Vs.append(V)
    Vs = np.stack(Vs)
    transfers = (np.stack([Vs[w + 1].T @ Vs[w]
                           for w in range(n_windows - 1)])
                 if n_windows > 1 else np.zeros((0, num_basis, num_basis)))
    return bounds, Vs, transfers


def predict_window_floor(snapshots, n_windows, num_basis, overlap=2):
    """The projection floor of a (W, N) shape on a snapshot stack
    (reference ``:211-252``): the largest over windows of the relative
    σ-tail beyond ``num_basis`` modes of the stacked window snapshots;
    ``inf`` where a window's stack cannot carry ``num_basis`` modes."""
    _bounds, stacks = _window_stacks(snapshots, n_windows, overlap)
    worst = 0.0
    for stacked in stacks:
        if min(stacked.shape) <= num_basis:
            return np.inf
        sig = np.linalg.svd(stacked, compute_uv=False)
        total = float(np.sum(sig**2))
        tail = float(np.sum(sig[num_basis:] ** 2))
        worst = max(worst, np.sqrt(tail / total) if total > 0 else 0.0)
    return worst


def select_fleet_shapes(cell_snapshots, candidates, target_floor, overlap=2,
                        margin=1.0):
    """The cheapest (W, N) per cell whose predicted floor meets
    ``target_floor / margin`` (reference ``:255-296``): candidates ranked
    by N² (the fused sweep's cost), then fewer windows; a cell no
    candidate serves takes the one of the smallest floor. Returns
    ``(cell_wn, floors)``."""
    by_cost = sorted(candidates, key=lambda wn: (wn[1] * wn[1], wn[0]))
    cell_wn, floors = [], []
    for snaps in cell_snapshots:
        preds = {wn: predict_window_floor(snaps, wn[0], wn[1], overlap)
                 for wn in by_cost}
        chosen = next((wn for wn in by_cost
                       if preds[wn] <= target_floor / margin), None)
        if chosen is None:
            chosen = min(by_cost, key=lambda wn: preds[wn])
        cell_wn.append(chosen)
        floors.append(preds[chosen])
    return cell_wn, floors
