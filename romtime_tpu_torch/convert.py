"""Serving state carried across from the JAX package.

A serving configuration travels as a flat ``dict[str, np.ndarray]``:

- windowed: the :class:`~romtime_tpu_torch.rom.windowed.WindowedServing`
  npz keys (``bounds``, ``Vs``, ``transfers``, ``combine_<source>``
  (W, n_out, k), ``trilinear`` (W, N², N), ``dilation_*``), and
  optionally the global configuration below under a ``global_`` prefix
  (the reference's windowed instance keeps its global basis and
  reductors beside the windows; the pivot-free guard runs on them);
- fleet: the :class:`~romtime_tpu_torch.rom.windowed.MuLocalWindowed`
  npz keys (``edges``, the cells' keys under ``c{c}_`` prefixes and, for a
  nested fleet, ``serving_ns``), optionally with the global configuration
  under ``global_``. The cells share one set of reductors: routing swaps
  the active windows, never the reductors, as in the reference
  (``romtime_tpu/rom/hrom.py:474-480``);
- global: the :class:`~romtime_tpu_torch.rom.GlobalServing` keys
  (``basis`` (nh, N), ``combine_<source>`` (n_out, k), the reductor's
  folded V·(PᵀU)⁻¹, and ``trilinear`` (N², N), the exact trilinear state
  table, which the port does not build: its banded assembly is offline
  work that stays in the JAX package);
- ``dofs_<source>`` for every θ source: the reductor's interpolation
  entries, (k, 2) for MDEIM, (k, 1) for DEIM;
- ``grid_<name>`` for every μ parameter: its box (lo, hi), in the
  serving object's parameter order (the guard and the solve policy
  probe the box's corners);
- the FOM configuration: ``fom_L0``, ``fom_nx``, ``fom_tf``, ``fom_nt``,
  ``fom_degree``, ``fom_bdf`` and the piston regime ``fom_which``.

``np.savez(path, **payload)`` persists it; the JAX side extracts the same
payload from a trained ``HyperReducedPiston``.
"""

import numpy as np

from .fom import OneDimensionalBurgers
from .problems import define_piston_problem
from .rom.engines.global_fused import GlobalServing
from .rom.rom import THETA_SOURCES, RomConstructorNonlinear, make_reductors
from .rom.windowed import MuLocalWindowed, WindowedServing

_FOM_KEYS = ("fom_L0", "fom_nx", "fom_tf", "fom_nt", "fom_degree",
             "fom_bdf", "fom_which")
_GLOBAL = "global_"


def piston_fom(L0, nx, tf, nt, degree=1, bdf="2", which="rest"):
    """The piston FOM (entry assembly) for a domain configuration."""
    domain, bcs, _forcing, _u0, Lt, dLt_dt = define_piston_problem(
        L=float(L0), nx=int(nx), tf=float(tf), nt=int(nt), which=which)
    return OneDimensionalBurgers(domain, dirichlet=bcs, Lt=Lt, dLt_dt=dLt_dt,
                                 degrees=int(degree), bdf_scheme=str(bdf))


def _fom_and_reductors(payload):
    """The FOM and the serving reductors of a payload."""
    missing = [k for k in _FOM_KEYS[:-1] if k not in payload]
    missing += [f"dofs_{n}" for n in THETA_SOURCES
                if f"dofs_{n}" not in payload]
    if missing:
        raise KeyError(f"serving payload lacks {missing}")
    fom = piston_fom(
        L0=payload["fom_L0"], nx=payload["fom_nx"], tf=payload["fom_tf"],
        nt=payload["fom_nt"], degree=payload["fom_degree"],
        bdf=str(np.asarray(payload["fom_bdf"])),
        which=str(np.asarray(payload.get("fom_which", "rest"))),
    )
    reductors = make_reductors(
        fom, {n: np.asarray(payload[f"dofs_{n}"]) for n in THETA_SOURCES})
    return fom, reductors


def _grid(payload):
    """The μ box, name → (lo, hi), from the ``grid_<name>`` keys."""
    grid = {k[len("grid_"):]: tuple(float(v) for v in np.asarray(payload[k]))
            for k in payload if k.startswith("grid_")}
    if not grid:
        raise KeyError("serving payload lacks the μ box: one "
                       "'grid_<name>' key, (lo, hi), per μ parameter")
    return grid


def _serving_arrays(payload):
    return {k: v for k, v in payload.items()
            if not k.startswith(("dofs_", "fom_", "grid_", _GLOBAL))}


def _windowed_object(payload, windows, device):
    """The serving object of a windowed or fleet payload, ``windows``
    active; the global configuration rides along when the payload has
    ``global_`` keys."""
    fom, reductors = _fom_and_reductors(payload)
    glob = {k[len(_GLOBAL):]: v for k, v in payload.items()
            if k.startswith(_GLOBAL)}
    gs = GlobalServing.from_arrays(glob) if glob else None
    return RomConstructorNonlinear(fom, reductors, windows, device=device,
                                   global_serving=gs, grid=_grid(payload))


def serving_from_arrays(payload, device="cuda"):
    """Build the port's windowed serving object from a plain-numpy
    payload, serving on ``device`` (the card by default); the global
    configuration rides along when the payload has ``global_`` keys."""
    return _windowed_object(
        payload, WindowedServing.from_arrays(_serving_arrays(payload)),
        device)


def fleet_serving_from_arrays(payload, device="cuda"):
    """Build the port's serving object for a μ-local fleet from a
    plain-numpy payload, serving on ``device`` (the card by default): the
    fleet attached as ``mulocal``, cell 0 as the active windows, and the
    global configuration when the payload has ``global_`` keys."""
    if "edges" not in payload:
        raise KeyError("fleet serving payload lacks 'edges'")
    ml = MuLocalWindowed.from_arrays(_serving_arrays(payload))
    rom = _windowed_object(payload, ml.cells[0], device)
    rom.mulocal = ml
    return rom


def global_serving_from_arrays(payload, device="cuda"):
    """Build the port's global-basis serving object (``engine="pallas"``)
    from a plain-numpy payload, serving on ``device`` (the card by
    default)."""
    if "basis" not in payload:
        raise KeyError("global serving payload lacks 'basis'")
    fom, reductors = _fom_and_reductors(payload)
    grid = _grid(payload)
    gs = GlobalServing.from_arrays(_serving_arrays(payload))
    return RomConstructorNonlinear(fom, reductors, device=device,
                                   global_serving=gs, grid=grid)


def _fom_and_dofs_arrays(rom, which):
    fom = rom.fom
    payload = {f"dofs_{name}": red.dofs_array()
               for name, red in rom._theta_sources().items()}
    payload.update({f"grid_{k}": np.array(box, np.float64)
                    for k, box in rom.grid.items()})
    payload.update(
        fom_L0=np.float64(fom.domain[fom.L0]), fom_nx=np.int64(fom.mesh.nx),
        fom_tf=np.float64(fom.domain[fom.T]),
        fom_nt=np.int64(fom.domain[fom.NT]),
        fom_degree=np.int64(fom.mesh.degree),
        fom_bdf=np.array(fom.BDF_SCHEME), fom_which=np.array(which),
    )
    return payload


def _windowed_arrays(rom, serving, which):
    payload = dict(serving.to_arrays(), **_fom_and_dofs_arrays(rom, which))
    if rom.global_serving is not None:
        payload.update({_GLOBAL + k: v for k, v in
                        rom.global_serving.to_arrays().items()})
    return payload


def serving_to_arrays(rom, which="rest"):
    """Inverse of :func:`serving_from_arrays`."""
    return _windowed_arrays(rom, rom.windows, which)


def fleet_serving_to_arrays(rom, which="rest"):
    """Inverse of :func:`fleet_serving_from_arrays`."""
    return _windowed_arrays(rom, rom.mulocal, which)


def global_serving_to_arrays(rom, which="rest"):
    """Inverse of :func:`global_serving_from_arrays`."""
    return dict(rom.global_serving.to_arrays(),
                **_fom_and_dofs_arrays(rom, which))
