"""Solution storage containers (counterpart of ``romtime_tpu/base.py``):
pickleable time series of solutions on the moving grid, as numpy arrays,
with physical-space probing by interpolation over each step's domain."""

import pickle

import numpy as np

from .conventions import PistonParameters, SolutionsStorageNames

__all__ = ["RomSolutionsStorage", "SolutionsStorage", "SolutionsStorageNames"]


class SolutionsStorage:
    """Time-series solution container: ``ts`` (nt,), ``mu`` (the parameter
    dict), ``domain`` (nh, nt) each step's physical dof coordinates,
    ``fom`` (nh, nt) the solutions with the lifting, ``snapshots`` (nh,
    nt) the homogeneous solutions (the reduced basis' training data)."""

    def __init__(self, ts, mu, domain, fom, snapshots=None) -> None:
        self.ts = np.array(ts)
        self.mu = dict(mu) if mu is not None else None
        self.snapshots = None if snapshots is None else np.array(snapshots)
        self.fom = np.array(fom)
        self.domain = np.array(domain)

    def to_pickle(self, name):
        with open(name + ".pkl", mode="wb") as fp:
            pickle.dump(self, fp)

    def compute_at(self, x):
        """The physical value at a fixed x over time: interpolated over
        each step's moving domain, scaled to physical units by a0 (dofs
        run left to right, so no flip; reference ``base.py:45-67``)."""
        points = np.array([
            np.interp(x, self.domain[:, idx], self.fom[:, idx])
            for idx in range(len(self.ts))
        ])
        return points * self.mu[PistonParameters.A0]


class RomSolutionsStorage(SolutionsStorage):
    """Adds the reduced coefficients' time series."""

    def __init__(self, ts, mu, domain, fom, rom) -> None:
        super().__init__(ts=ts, mu=mu, domain=domain, fom=fom)
        self.rom = np.array(rom)
