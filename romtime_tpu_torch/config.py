"""Typed configuration (counterpart of ``romtime_tpu/config.py``).

The drivers take nested dicts (``grid``, ``fom_params``, ``rom_params``,
``deim_params``, ``models``), keyed by the names in ``conventions``.
These dataclasses mirror that schema one to one, validate a few fields
and emit exactly the dicts the drivers consume, so dict-based code keeps
working; the typed form is sugar on top.
"""

from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np

from .conventions import Domain, OperatorType, RomParameters


@dataclass
class DomainConfig:
    """Space-time domain (keys at conventions.py Domain)."""

    L0: float
    T: float
    nx: int
    nt: int

    def to_dict(self):
        return {
            Domain.L0: self.L0,
            Domain.T: self.T,
            Domain.NX: self.nx,
            Domain.NT: self.nt,
        }

    @property
    def dt(self):
        return self.T / self.nt

    def timesteps(self):
        return np.linspace(self.dt, self.T, self.nt)


@dataclass
class FomConfig:
    """FOM construction parameters (reference driver ctor dict,
    rom/hrom.py:229-255)."""

    domain: DomainConfig
    dirichlet: Dict[str, Any]
    forcing_term: Optional[Callable] = None
    u0: Optional[Callable] = None
    exact_solution: Optional[Callable] = None
    Lt: Optional[Callable] = None
    dLt_dt: Optional[Callable] = None
    grid_params: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self):
        out = dict(
            domain=self.domain.to_dict(),
            dirichlet=self.dirichlet,
            forcing_term=self.forcing_term,
            u0=self.u0,
            exact_solution=self.exact_solution,
            grid_params=self.grid_params,
        )
        if self.Lt is not None:
            out["Lt"] = self.Lt
            out["dLt_dt"] = self.dLt_dt
        return out


@dataclass
class RomConfig:
    """Reduced-basis construction knobs (keys at conventions.py
    RomParameters)."""

    num_snapshots: int
    srom_truncate: int = 0
    num_mu: Optional[int] = None
    srom_keep: Optional[int] = None
    nmdeim_size: Optional[int] = None
    tol_time: Optional[float] = None
    tol_mu: Optional[float] = None

    def __post_init__(self):
        if self.num_snapshots is not None and self.num_snapshots < 1:
            raise ValueError("num_snapshots must be >= 1.")
        if self.srom_truncate < 0:
            raise ValueError("srom_truncate must be >= 0.")

    def to_dict(self):
        return {
            RomParameters.NUM_SNAPSHOTS: self.num_snapshots,
            RomParameters.NUM_MU: self.num_mu,
            RomParameters.SROM_TRUNCATE: self.srom_truncate,
            RomParameters.SROM_KEEP: self.srom_keep,
            RomParameters.NMDEIM_SIZE: self.nmdeim_size,
            RomParameters.TOL_TIME: self.tol_time,
            RomParameters.TOL_MU: self.tol_mu,
        }


@dataclass
class TreeWalkConfig:
    """(M)DEIM tree-walk parameters (keys at conventions.py RomParameters;
    consumed at deim/deim.py run())."""

    ts: Sequence[float]
    num_snapshots: Optional[int] = None
    num_mu: Optional[int] = None
    num_time: Optional[int] = None
    tol_mu: Optional[float] = None
    tol_time: Optional[float] = None
    num_online: Optional[int] = None

    def to_dict(self):
        return {
            RomParameters.TS: np.asarray(self.ts),
            RomParameters.NUM_SNAPSHOTS: self.num_snapshots,
            RomParameters.NUM_MU: self.num_mu,
            RomParameters.NUM_TIME: self.num_time,
            RomParameters.TOL_MU: self.tol_mu,
            RomParameters.TOL_TIME: self.tol_time,
            RomParameters.NUM_ONLINE: self.num_online,
        }


@dataclass
class ModelsConfig:
    """Per-operator hyper-reduction switches (reference usage:
    tests/fom/test_piston.py:443-450)."""

    mass: bool = True
    stiffness: bool = True
    rhs: bool = True
    convection: bool = False
    nonlinear_lifting: bool = False
    trilinear: bool = False
    nonlinear: bool = False

    def to_dict(self):
        return {
            OperatorType.MASS: self.mass,
            OperatorType.STIFFNESS: self.stiffness,
            OperatorType.RHS: self.rhs,
            OperatorType.CONVECTION: self.convection,
            OperatorType.NONLINEAR_LIFTING: self.nonlinear_lifting,
            OperatorType.TRILINEAR: self.trilinear,
            OperatorType.NONLINEAR: self.nonlinear,
        }


@dataclass
class PipelineConfig:
    """Everything a driver needs; ``build(driver_cls, device)``
    instantiates it."""

    grid: Dict[str, Any]
    fom: FomConfig
    rom: RomConfig
    deim: TreeWalkConfig
    mdeim: TreeWalkConfig
    models: ModelsConfig
    mdeim_nonlinear: Optional[TreeWalkConfig] = None
    rnd: Optional[int] = None

    def build(self, driver_cls, device="cuda"):
        """``driver_cls`` (a driver of ``rom.hrom``) on these settings,
        built on ``device`` (the card unless ``device="cpu"``)."""
        kwargs = dict(
            grid=self.grid,
            fom_params=self.fom.to_dict(),
            rom_params=self.rom.to_dict(),
            deim_params=self.deim.to_dict(),
            mdeim_params=self.mdeim.to_dict(),
            models=self.models.to_dict(),
            rnd=np.random.RandomState(self.rnd),
            device=device,
        )
        if self.mdeim_nonlinear is not None:
            kwargs["mdeim_nonlinear_params"] = self.mdeim_nonlinear.to_dict()
        return driver_cls(**kwargs)
