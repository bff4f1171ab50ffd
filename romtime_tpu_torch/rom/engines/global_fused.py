"""Global-basis serving engine, ``engine="pallas"`` (counterpart of
``romtime_tpu/rom/engines/pallas_global.py``).

The global configuration is served as one window that spans the whole
time grid, so the windowed engine's two stages carry it:

1. :func:`global_tables` is :func:`windowed_tables` on that one-window
   view: the reference builds the same padded Bm, Bk (dt-scaled, the
   identity column on a constant-1 θ row), Bf, T0 and VE
   (``pallas_global.py:107-196``). :func:`global_prep` is the windowed
   prep without a dilation law (``:90-98``, ``:166-175``): the raw
   gathered entries it streams are the reference's f32 ``_thetas_traced``
   (the reductors' ``_entries_traced`` here, what their ``_thetas_traced``
   returns under float32 serving), which pair with the folded combines.
2. :func:`global_sweep` routes on the precompute budget (``:204-221``):
   while the materialized tables (2·nt·NP²·B·4 bytes) fit it, MN/KL/fN
   are plain products of the combine tensors with the θ rows (the
   reference leaves them to XLA outside any kernel), formed in K4's
   lane-major layout, and K4 runs once; otherwise K5 runs once.
"""

from dataclasses import dataclass, field

import numpy as np
import torch

from ...ops.global_sweep import (
    online_sweep_pallas,
    online_sweep_theta_pallas,
)
from ...ops.windowed_fused import _no_tf32
from ..windowed import WindowedServing
from .windowed_fused import (
    materialize,
    live_rows,
    time_grid,
    window_inputs,
    window_operators_lanes,
    windowed_prep,
    windowed_tables,
)

#: The reference's lane block: its routing gate takes the global engine
#: only for batches of whole blocks (the kernels here take any batch).
GATE_LANES = 128
#: Largest reduced dimension the global engine serves.
GATE_N = 64


@dataclass
class GlobalServing:
    """Global serving artifacts: the basis, the folded combine per θ
    source (V·(PᵀU)⁻¹ of its reductor, float64) and the trilinear state
    table."""

    basis: np.ndarray                              # (nh, N)
    combines: dict = field(default_factory=dict)   # name → (n_out, k)
    trilinear: np.ndarray = None                   # (N², N) or None

    @property
    def N(self):
        return self.basis.shape[1]

    def window_view(self, nt):
        """The same configuration as one window over ``nt`` steps."""
        N = self.N
        return WindowedServing(
            bounds=np.array([0, nt]), Vs=np.asarray(self.basis)[None],
            transfers=np.zeros((0, N, N)),
            combines={k: np.asarray(C)[None] for k, C in
                      self.combines.items()},
            trilinear=(None if self.trilinear is None
                       else np.asarray(self.trilinear)[None]))

    def to_arrays(self):
        """The payload keys ``basis``, ``combine_<source>``, ``trilinear``."""
        payload = {"basis": np.asarray(self.basis)}
        for name, C in self.combines.items():
            payload[f"combine_{name}"] = np.asarray(C)
        if self.trilinear is not None:
            payload["trilinear"] = np.asarray(self.trilinear)
        return payload

    @classmethod
    def from_arrays(cls, data):
        return cls(basis=data["basis"],
                   combines={k[len("combine_"):]: data[k] for k in data
                             if k.startswith("combine_")},
                   trilinear=data.get("trilinear"))

    @classmethod
    def from_rom(cls, rom):
        """The global configuration of a built and projected ROM: its
        basis, each θ source's folded combine V·(PᵀU)⁻¹ on the reduced
        collateral basis (float64) and its trilinear state table (the
        keys a JAX-built ROM's payload carries)."""
        basis = np.asarray(rom.basis)
        return cls(basis=basis,
                   combines={name: red._combine_matrix(red.ROM)
                             for name, red in rom._theta_sources().items()},
                   trilinear=rom._trilinear_state_table(basis))


def supported(B, N, dtype, with_trilinear):
    """The reference's routing gate ``_pallas_supported``
    (``pallas_global.py:49-66``): N ≤ 64, whole 128-lane blocks, float32
    compute and the trilinear state table present (every operator is
    hyper-reduced in a port serving object)."""
    return (N <= GATE_N and B % GATE_LANES == 0 and dtype == torch.float32
            and with_trilinear)


def global_tables(gs, nt, dt, stiff_names, device):
    """Constant tables of the one-window view (leading window axis of 1);
    the sweep takes index 0 of Bm, Bk, Bf, T0 and VE."""
    return windowed_tables(gs.window_view(nt), dt, stiff_names, device)


def global_prep(fom, sources, gs, tables, mu):
    """Stage 1: THm, THk, THf (nt, k8, B), g (nt, 8, B) and b0 (1, B)."""
    view = gs.window_view(int(fom.domain[fom.NT]))
    return windowed_prep(fom, sources, view, tables, mu)


def global_branch(nt, NP, B, precompute_choice):
    """``"matrices"`` (K4) when :func:`materialize` holds, else
    ``"thetas"`` (K5)."""
    return ("matrices" if materialize(nt, NP, B, precompute_choice)
            else "thetas")


def sweep_materialized(fom, gs, prepped, tables):
    """MN/KL/fN materialized over the whole grid (lane-major), then one
    K4 launch. Returns (probes (nt, 8, B), uN (NP, B))."""
    (THm, THk, THf, g, b0), kw = window_inputs(fom, gs, prepped)
    if THm.is_cuda:
        _no_tf32()
    MN, KL, fN = window_operators_lanes(tables, 0, THm, THk, THf, 0,
                                        THm.shape[0])
    return online_sweep_pallas(MN, KL, fN, g, tables["T0"][0],
                               tables["VE"][0], b0, lane_major=True, **kw)


def sweep_theta(fom, gs, prepped, tables):
    """One K5 launch over the θ streams' live rows."""
    (THm, THk, THf, g, b0), kw = window_inputs(fom, gs, prepped)
    return online_sweep_theta_pallas(
        THm, THk, THf, g, tables["Bm"][0], tables["Bk"][0], tables["Bf"][0],
        tables["T0"][0], tables["VE"][0], b0, **kw, **live_rows(tables))


def global_sweep(fom, gs, prepped, tables, precompute_choice):
    """Stage 2 through the branch :func:`global_branch` picks. Returns
    (nt, …, B) tensors: t, probes (nt, 2, B), uN_final (N, B)."""
    THm = prepped["THm"]
    nt, _k, B = THm.shape
    branch = global_branch(nt, tables["VE"].shape[2], B, precompute_choice)
    sweep = {"matrices": sweep_materialized, "thetas": sweep_theta}[branch]
    probes, uN = sweep(fom, gs, prepped, tables)
    return {"t": time_grid(fom, None, THm.dtype, THm.device),
            "probes": probes[:, :2, :], "uN_final": uN[:gs.N, :]}
