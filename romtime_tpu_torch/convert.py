"""Serving state as plain numpy: carried across from the JAX package,
or from a ROM the port built (``GlobalServing.from_rom``).

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
  table), and, optional, the reductors'
  ``PT_U_<source>`` (k, k) and ``basis_rom_<source>`` (n_out, k), which
  float64 serving on the global basis needs (the PᵀU θ-solve);
- ``dofs_<source>`` for every θ source: the reductor's interpolation
  entries, (k, 2) for MDEIM, (k, 1) for DEIM;
- ``grid_<name>`` for every μ parameter: its box (lo, hi), in the
  serving object's parameter order (the guard and the solve policy
  probe the box's corners);
- the FOM configuration: ``fom_L0``, ``fom_nx``, ``fom_tf``, ``fom_nt``,
  ``fom_degree``, ``fom_bdf``, the piston regime ``fom_which`` and,
  where it is set, ``fom_project_u0``; :func:`fom_from_arrays` builds
  the FOM from these keys alone, ready to ``solve()``.

An estimator (:func:`estimator_from_arrays`) is a ROM payload of any of
these forms plus its S-ROM under an ``srom_`` prefix: a global
configuration (``srom_basis``, ``srom_combine_<source>``,
``srom_trilinear``, ``srom_basis_rom_<source>``; PᵀU is the ROM's, whose
DEIM the S-ROM shares) or a :class:`WindowedServing` at N+Δ
(``srom_bounds``, ``srom_Vs``, …). A nested fleet's S-ROM cells travel
in the fleet payload itself (``serving_ns``).

``np.savez(path, **payload)`` persists it; the JAX side extracts the same
payload from a trained ``HyperReducedPiston``, and a port-built one
serves without it (its ROM's ``global_serving``). Every object here is
made through the artifact forms ``RomConstructorNonlinear.from_artifacts``
and ``HyperReducedPiston.from_serving``.
"""

import numpy as np

from .fom import OneDimensionalBurgers
from .problems import define_piston_problem
from .rom.engines.global_fused import GlobalServing
from .rom.hrom import HyperReducedPiston
from .rom.rom import THETA_SOURCES, RomConstructorNonlinear, make_reductors
from .rom.windowed import MuLocalWindowed, WindowedServing

_FOM_KEYS = ("fom_L0", "fom_nx", "fom_tf", "fom_nt", "fom_degree",
             "fom_bdf", "fom_which")
_GLOBAL = "global_"
_SROM = "srom_"
_REDUCED = ("PT_U", "basis_rom")


def piston_fom(L0, nx, tf, nt, degree=1, bdf="2", which="rest",
               project_u0=False, device="cuda"):
    """The piston FOM for a domain configuration, set up: it assembles at
    entries and over the full band, and its ``solve()`` steps on
    ``device`` (the card by default)."""
    domain, bcs, forcing, u0, Lt, dLt_dt = define_piston_problem(
        L=float(L0), nx=int(nx), tf=float(tf), nt=int(nt), which=which)
    fom = OneDimensionalBurgers(
        domain, dirichlet=bcs, forcing_term=forcing, u0=u0, Lt=Lt,
        dLt_dt=dLt_dt, degrees=int(degree), bdf_scheme=str(bdf),
        project_u0=bool(project_u0), device=device)
    fom.setup()
    return fom


def fom_from_arrays(payload, device="cuda"):
    """The piston FOM of a payload's ``fom_*`` keys (``fom_which``
    default "rest", ``fom_project_u0`` default False), on ``device``."""
    missing = [k for k in _FOM_KEYS[:-1] if k not in payload]
    if missing:
        raise KeyError(f"FOM payload lacks {missing}")
    return piston_fom(
        L0=payload["fom_L0"], nx=payload["fom_nx"], tf=payload["fom_tf"],
        nt=payload["fom_nt"], degree=payload["fom_degree"],
        bdf=str(np.asarray(payload["fom_bdf"])),
        which=str(np.asarray(payload.get("fom_which", "rest"))),
        project_u0=bool(np.asarray(payload.get("fom_project_u0", False))),
        device=device)


def _reduced_parts(arrays, PT_U=None):
    """source → the reductor's optional ``PT_U`` and ``basis_rom`` from a
    global configuration's keys (``PT_U`` from the mapping ``PT_U`` where
    the keys lack it)."""
    parts = {}
    for name in THETA_SOURCES:
        got = {attr: arrays[f"{attr}_{name}"] for attr in _REDUCED
               if f"{attr}_{name}" in arrays}
        if PT_U is not None and "PT_U" not in got and name in PT_U:
            got["PT_U"] = PT_U[name]
        parts[name] = got
    return parts


def _reduced_arrays(rom):
    """The ``PT_U_<source>``/``basis_rom_<source>`` keys of a serving
    object's reductors (the ones they hold)."""
    out = {}
    for name, red in rom._theta_sources().items():
        for attr in _REDUCED:
            if getattr(red, attr) is not None:
                out[f"{attr}_{name}"] = np.asarray(getattr(red, attr))
    return out


def _fom_and_reductors(payload, reduced=None, device="cuda"):
    """The FOM and the serving reductors of a payload (``reduced``: the
    global configuration's keys that carry PᵀU and ``basis_rom``)."""
    missing = [k for k in _FOM_KEYS[:-1] if k not in payload]
    missing += [f"dofs_{n}" for n in THETA_SOURCES
                if f"dofs_{n}" not in payload]
    if missing:
        raise KeyError(f"serving payload lacks {missing}")
    fom = fom_from_arrays(payload, device)
    reductors = make_reductors(
        fom, {n: np.asarray(payload[f"dofs_{n}"]) for n in THETA_SOURCES},
        _reduced_parts(reduced or {}))
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
    glob = {k[len(_GLOBAL):]: v for k, v in payload.items()
            if k.startswith(_GLOBAL)}
    fom, reductors = _fom_and_reductors(payload, glob, device)
    gs = GlobalServing.from_arrays(glob) if glob else None
    return RomConstructorNonlinear.from_artifacts(
        fom, reductors, windows, device=device, global_serving=gs,
        grid=_grid(payload))


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
    fom, reductors = _fom_and_reductors(payload, payload, device)
    grid = _grid(payload)
    gs = GlobalServing.from_arrays(_serving_arrays(payload))
    return RomConstructorNonlinear.from_artifacts(
        fom, reductors, device=device, global_serving=gs, grid=grid)


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
    if fom.project_u0:
        payload["fom_project_u0"] = np.bool_(True)
    return payload


def _global_arrays(rom):
    """A serving object's global configuration keys: the
    :class:`GlobalServing` keys and its reductors' PᵀU and ``basis_rom``."""
    return dict(rom.global_serving.to_arrays(), **_reduced_arrays(rom))


def _windowed_arrays(rom, serving, which):
    payload = dict(serving.to_arrays(), **_fom_and_dofs_arrays(rom, which))
    if rom.global_serving is not None:
        payload.update({_GLOBAL + k: v for k, v in
                        _global_arrays(rom).items()})
    return payload


def serving_to_arrays(rom, which="rest"):
    """Inverse of :func:`serving_from_arrays`."""
    return _windowed_arrays(rom, rom.windows, which)


def fleet_serving_to_arrays(rom, which="rest"):
    """Inverse of :func:`fleet_serving_from_arrays`."""
    return _windowed_arrays(rom, rom.mulocal, which)


def global_serving_to_arrays(rom, which="rest"):
    """Inverse of :func:`global_serving_from_arrays`."""
    return dict(_global_arrays(rom), **_fom_and_dofs_arrays(rom, which))


def estimator_from_arrays(payload, device="cuda"):
    """Build the port's S-ROM estimator (:class:`HyperReducedPiston`)
    from a plain-numpy payload, serving on ``device`` (the card by
    default): the ROM from the payload's own keys (a fleet when it has
    ``edges``, windows when it has ``bounds``, else a global basis), the
    S-ROM from the ``srom_`` keys (a global configuration sharing the
    ROM's FOM, dofs and PᵀU, or a windowed one), none without them."""
    rom_payload = {k: v for k, v in payload.items()
                   if not k.startswith(_SROM)}
    srom_arrays = {k[len(_SROM):]: v for k, v in payload.items()
                   if k.startswith(_SROM)}
    if "edges" in rom_payload:
        rom = fleet_serving_from_arrays(rom_payload, device)
    elif "bounds" in rom_payload:
        rom = serving_from_arrays(rom_payload, device)
    else:
        rom = global_serving_from_arrays(rom_payload, device)
    srom = windows_srom = None
    if "basis" in srom_arrays:
        PT_U = {name: red.PT_U for name, red in rom.reductors.items()
                if red.PT_U is not None}
        reductors = make_reductors(
            rom.fom, {name: red.dofs_array()
                      for name, red in rom.reductors.items()},
            _reduced_parts(srom_arrays, PT_U))
        srom = RomConstructorNonlinear.from_artifacts(
            rom.fom, reductors, device=device,
            global_serving=GlobalServing.from_arrays(srom_arrays),
            grid=rom.grid)
    elif "bounds" in srom_arrays:
        windows_srom = WindowedServing.from_arrays(srom_arrays)
    elif srom_arrays:
        raise KeyError("the S-ROM keys hold neither a global configuration "
                       "('srom_basis') nor windows ('srom_bounds')")
    return HyperReducedPiston.from_serving(rom, srom=srom,
                                           windows_srom=windows_srom)


def estimator_to_arrays(est, which="rest"):
    """Inverse of :func:`estimator_from_arrays`."""
    rom = est.rom
    if rom.mulocal is not None:
        payload = fleet_serving_to_arrays(rom, which)
    elif rom.windows is not None:
        payload = serving_to_arrays(rom, which)
    else:
        payload = global_serving_to_arrays(rom, which)
    if est.srom is not None:
        srom = {k: v for k, v in _global_arrays(est.srom).items()
                if not k.startswith("PT_U_")}
    elif est.windows_srom is not None:
        srom = est.windows_srom.to_arrays()
    else:
        srom = {}
    payload.update({_SROM + k: v for k, v in srom.items()})
    return payload
