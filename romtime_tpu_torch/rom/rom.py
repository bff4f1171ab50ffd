"""Piston ROM serving (counterpart of the serving path of
``romtime_tpu/rom/rom.py``: ``RomConstructorNonlinear.solve_batch`` with
``mode="probes"`` on windowed serving, i.e. the ``"windowed-pallas"``
engine).

The offline build (POD, DEIM training, window construction) stays in the
JAX package; a serving object here is made from its artifacts
(``convert.serving_from_arrays``) or from a seeded synthetic cell
(``testing.synthetic``).
"""

import numpy as np
import torch

from ..conventions import PistonParameters, Stage
from ..dtypes import asarray
from ..deim import (
    DiscreteEmpiricalInterpolation,
    MatrixDiscreteEmpiricalInterpolation,
)
from .engines.policy import windowed_solve_group
from .engines.windowed_fused import (
    certify_pivot_free,
    windowed_prep,
    windowed_sweep,
    windowed_tables,
    stiffness_side,
)

#: θ source name → (reductor class, FOM assembly method), in the
#: reference's ``_theta_sources`` order (rom.py:525, :1277, :1421), which
#: fixes the stiffness-side row order of the θ tables.
THETA_SOURCES = {
    "mass": (MatrixDiscreteEmpiricalInterpolation, "assemble_mass"),
    "stiffness": (MatrixDiscreteEmpiricalInterpolation,
                  "assemble_stiffness"),
    "rhs_vec": (DiscreteEmpiricalInterpolation, "assemble_rhs"),
    "convection": (MatrixDiscreteEmpiricalInterpolation,
                   "assemble_convection"),
    "nonlinear_lifting": (MatrixDiscreteEmpiricalInterpolation,
                          "assemble_nonlinear_lifting"),
}


def make_reductors(fom, dofs):
    """Serving reductors bound to ``fom`` from per-source dofs."""
    return {
        name: cls(assemble=getattr(fom, method), dofs=dofs[name], name=name)
        for name, (cls, method) in THETA_SOURCES.items()
    }


class RomConstructorNonlinear:
    """Windowed piston serving on one device.

    ``reductors`` maps every θ source name of :data:`THETA_SOURCES` to a
    DEIM reductor bound to ``fom``; ``windows`` is the active
    :class:`~romtime_tpu_torch.rom.windowed.WindowedServing`."""

    def __init__(self, fom, reductors, windows, device="cpu"):
        missing = set(THETA_SOURCES) - set(reductors)
        if missing:
            raise ValueError(f"missing θ sources: {sorted(missing)}")
        self.fom = fom
        self.reductors = dict(reductors)
        self.device = torch.device(device)
        self._set_serving_windows(windows)

    @property
    def N(self):
        return self.windows.N

    def _theta_sources(self):
        """name → reductor, in the reference's source order."""
        return {name: self.reductors[name] for name in THETA_SOURCES}

    def _set_serving_windows(self, win):
        """Swap the active windowed serving tables (the cached device
        tables and the pivot check belong to the old ones)."""
        self.windows = win
        self._tables = None
        self._pivot_cert = None

    def _windowed_tables(self):
        if self._tables is None:
            self._tables = windowed_tables(
                self.windows, self.fom.dt,
                stiffness_side(self._theta_sources()), self.device)
        return self._tables

    def _mu_batch(self, mus):
        """(B,) tensors per μ name, in the active compute dtype (float32
        serving; float64 under ``compute_dtype_scope`` for checks)."""
        names = sorted(mus[0].keys())
        return {k: asarray([float(mu[k]) for mu in mus], device=self.device)
                for k in names}

    def prep(self, mus):
        """Stage 1 for a list of μ dicts: the θ/probe tables on device."""
        return windowed_prep(self.fom, self._theta_sources(), self.windows,
                             self._windowed_tables(), self._mu_batch(mus))

    def solve_batch(self, mus, step=Stage.ONLINE, mode="probes",
                    probe_reduce=None):
        """Serve a μ batch: θ prep, then one fused K1 sweep.

        Returns batch-first numpy arrays: ``t``, ``probes`` (B, nt, 2) —
        or (B, 2) / (B, nt//k, 2) with ``probe_reduce`` "mean" / k —
        ``uN_final`` (B, N), and ``dil``/``dil_oor`` with a dilation law.
        ``step`` is the reference's stage tag; serving keeps no record of
        the μ it served."""
        if mode != "probes":
            raise NotImplementedError(
                f"mode {mode!r} is not ported; serving runs mode='probes'")
        if self.windows is None:
            raise ValueError("no windowed serving configuration attached")
        group, paired_mode = windowed_solve_group()

        tables = self._windowed_tables()
        prepped = self.prep(mus)
        if self._pivot_cert is None:
            self._pivot_cert = certify_pivot_free(tables, prepped, self.N)
        outs = windowed_sweep(self.fom, self.windows, prepped, tables,
                              group, paired_mode)
        if probe_reduce is not None:
            outs["probes"] = self._reduce_probes(outs["probes"],
                                                 probe_reduce)
        return {k: (v.movedim(-1, 0) if v.ndim >= 2 else v).cpu().numpy()
                for k, v in outs.items()}

    @staticmethod
    def _reduce_probes(probes, probe_reduce):
        """On-device probe consumer: "mean" time-averages (nt, P, B) to
        (P, B); an int k keeps every k-th step."""
        if probe_reduce == "mean":
            return probes.mean(dim=0)
        if (isinstance(probe_reduce, (int, np.integer))
                and not isinstance(probe_reduce, bool) and probe_reduce >= 1):
            k = int(probe_reduce)
            return probes[k - 1::k]
        raise ValueError(f"probe_reduce must be 'mean' or a positive int "
                         f"stride, got {probe_reduce!r}")

    @staticmethod
    def compute_piston_mach_number(sample):
        """δω/a0."""
        return (sample[PistonParameters.DELTA]
                * sample[PistonParameters.OMEGA]
                / sample[PistonParameters.A0])
