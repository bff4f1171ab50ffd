"""Serving state carried across from the JAX package.

A serving configuration travels as a flat ``dict[str, np.ndarray]``:

- the :class:`~romtime_tpu_torch.rom.windowed.WindowedServing` npz keys
  (``bounds``, ``Vs``, ``transfers``, ``combine_<source>``,
  ``trilinear``, ``dilation_*``);
- ``dofs_<source>`` for every θ source: the reductor's interpolation
  entries, (k, 2) for MDEIM, (k, 1) for DEIM;
- the FOM configuration: ``fom_L0``, ``fom_nx``, ``fom_tf``, ``fom_nt``,
  ``fom_degree``, ``fom_bdf`` and the piston regime ``fom_which``.

``np.savez(path, **payload)`` persists it; the JAX side extracts the same
payload from a trained ``HyperReducedPiston``.
"""

import numpy as np

from .fom import OneDimensionalBurgers
from .problems import define_piston_problem
from .rom.rom import THETA_SOURCES, RomConstructorNonlinear, make_reductors
from .rom.windowed import WindowedServing

_FOM_KEYS = ("fom_L0", "fom_nx", "fom_tf", "fom_nt", "fom_degree",
             "fom_bdf", "fom_which")


def piston_fom(L0, nx, tf, nt, degree=1, bdf="2", which="rest"):
    """The piston FOM (entry assembly) for a domain configuration."""
    domain, bcs, _forcing, _u0, Lt, dLt_dt = define_piston_problem(
        L=float(L0), nx=int(nx), tf=float(tf), nt=int(nt), which=which)
    return OneDimensionalBurgers(domain, dirichlet=bcs, Lt=Lt, dLt_dt=dLt_dt,
                                 degrees=int(degree), bdf_scheme=str(bdf))


def serving_from_arrays(payload, device="cpu"):
    """Build the port's serving object from a plain-numpy payload."""
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
    win = WindowedServing.from_arrays(
        {k: v for k, v in payload.items()
         if not k.startswith(("dofs_", "fom_"))})
    return RomConstructorNonlinear(fom, reductors, win, device=device)


def serving_to_arrays(rom, which="rest"):
    """Inverse of :func:`serving_from_arrays`."""
    fom = rom.fom
    payload = rom.windows.to_arrays()
    for name, red in rom._theta_sources().items():
        payload[f"dofs_{name}"] = red.dofs_array()
    payload.update(
        fom_L0=np.float64(fom.domain[fom.L0]), fom_nx=np.int64(fom.mesh.nx),
        fom_tf=np.float64(fom.domain[fom.T]),
        fom_nt=np.int64(fom.domain[fom.NT]),
        fom_degree=np.int64(fom.mesh.degree),
        fom_bdf=np.array(fom.BDF_SCHEME), fom_which=np.array(which),
    )
    return payload
