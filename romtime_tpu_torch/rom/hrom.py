"""S-ROM error certification, the serving subset of ``HyperReducedPiston``
(counterpart of ``romtime_tpu/rom/hrom.py:1149-1258``).

A sacrificial ROM (S-ROM) carries Δ more modes than the ROM it certifies,
its basis nesting the ROM's. Per (μ, t) the estimator is the RMS of the
reconstruction of the two trajectories' difference, which, the S-ROM
basis having orthonormal columns, is the coefficient-difference norm
‖uN_srom − pad(uN)‖₂/√Nh: it never leaves the reduced space. The two
sweeps run on the device (``solve_batch(..., host=False)``), the norm
too, and only the (B, nt) estimator is fetched. The offline build that
produces the ROM, the S-ROM and the nested windows stays in the JAX
package; an estimator here comes from its artifacts
(``convert.estimator_from_arrays``) or from seeded synthetic data
(``testing.synthetic.synthetic_estimator``).
"""

import numpy as np
import torch

from ..conventions import Errors, Stage
from ..utils.numeric import time_average


class HyperReducedPiston:
    """``rom`` is the serving
    :class:`~romtime_tpu_torch.rom.rom.RomConstructorNonlinear`; ``srom``
    the global S-ROM serving object (its basis nesting the ROM's global
    basis) or None; ``windows_srom`` the
    :class:`~romtime_tpu_torch.rom.windowed.WindowedServing` at N+Δ whose
    windows nest the ROM's, or None. ``errors`` records each estimate's
    per-μ series under ``f"{step}-estimator"``."""

    def __init__(self, rom, srom=None, windows_srom=None):
        self.rom = rom
        self.srom = srom
        self.windows_srom = windows_srom
        self.errors = {}

    def estimate_batch(self, mus, step=Stage.ONLINE, engine=None):
        """Batched S-ROM certification (reference ``hrom.py:1149-1217``):
        one lanes sweep per ROM in ``mode="reduced"``, in the compute dtype
        (float64 under ``compute_dtype_scope``, as the reference certifies
        with x64 on).

        ``engine="windowed"``: both sweeps on the windowed lanes engine,
        the second with ``windows_srom`` swapped in as the active windows
        (restored after, whatever happens); Nh is the windows' row count.
        Otherwise ``rom`` and ``srom`` each serve ``solve_batch(mode=
        "reduced")``, which resolves to the global lanes engine; Nh is the
        S-ROM basis's row count.

        Returns ``estimator`` (B, nt) and ``average`` (B,) (trapezoid time
        averages, each over its μ's own clock on registered windows) as
        numpy, and the two sweeps' raw outputs under ``"rom"``
        and ``"srom"`` as their (nt, …, B) device tensors (the reference
        returns them batch-first on the host; here only the estimator
        crosses to the host)."""
        rom = self.rom
        if engine == "windowed":
            if rom.windows is None or self.windows_srom is None:
                raise ValueError("windowed estimation needs the ROM's windows "
                                 "and the nested S-ROM windows "
                                 "(windows_srom)")
            out_rom = rom.solve_batch(mus, step=step, mode="reduced",
                                      engine="windowed", host=False)
            serving = rom.windows
            rom._set_serving_windows(self.windows_srom)
            try:
                out_srom = rom.solve_batch(mus, step=step, mode="reduced",
                                           engine="windowed", host=False)
            finally:
                rom._set_serving_windows(serving)
            Nh = np.asarray(serving.Vs).shape[1]
        else:
            if self.srom is None:
                raise ValueError("global estimation needs the S-ROM serving "
                                 "object (srom)")
            out_rom = rom.solve_batch(mus, step=step, mode="reduced",
                                      host=False)
            out_srom = self.srom.solve_batch(mus, step=step, mode="reduced",
                                             host=False)
            Nh = np.asarray(self.srom.global_serving.basis).shape[0]

        uN = out_rom["uN"]                          # (nt, N, B)
        diff = out_srom["uN"].clone()               # (nt, N̂, B)
        diff[:, :uN.shape[1]] -= uN
        estimator = (torch.linalg.vector_norm(diff, dim=1)
                     / np.sqrt(Nh)).T.cpu().numpy()  # (B, nt)
        ts = out_rom["t"].cpu().numpy()
        if ts.ndim == 2:
            # Registered windows: each lane on its own dilated clock
            # (nt, B). The reference broadcasts every lane's clock against
            # each series there and returns a (B, B) average; each μ is
            # averaged over its own clock here.
            average = np.array([time_average(ts[:, b], e)
                                for b, e in enumerate(estimator)])
        else:
            average = np.array([time_average(ts, e) for e in estimator])
        self.errors[f"{step}-estimator"] = {
            idx: estimator[idx] for idx in range(len(mus))}
        return {Errors.ESTIMATOR: estimator,
                Errors.AVERAGE_ESTIMATOR: average,
                "rom": out_rom, "srom": out_srom}

    def estimate_batch_mulocal(self, mus, step=Stage.ONLINE):
        """S-ROM certification of the μ-local fleet (reference
        ``hrom.py:1219-1258``): each μ is routed to its Mach cell
        (``route_mulocal``) and estimated on the windowed branch against
        that cell's nested S-ROM windows (``mulocal.cells_srom``).
        ``windows_srom`` is restored after, whatever happens. Returns
        ``estimator`` (B, nt) and ``average`` (B,), and each μ's two
        trajectories, ``"rom"`` (nt, N) and ``"srom"`` (nt, N̂) rows on the
        host (a list of rows where the cells' N differ), all merged back
        in input order (the reference returns the first two only)."""
        rom = self.rom
        ml = rom.mulocal
        if ml is None or ml.cells_srom is None:
            raise ValueError("μ-local estimation needs a fleet with nested "
                             "S-ROM cells (mulocal.cells_srom)")
        prev_srom = self.windows_srom

        def run_cell(c, sub):
            self.windows_srom = ml.cells_srom[c]
            out = self.estimate_batch(sub, step=step, engine="windowed")
            return {Errors.ESTIMATOR: out[Errors.ESTIMATOR],
                    Errors.AVERAGE_ESTIMATOR: out[Errors.AVERAGE_ESTIMATOR],
                    **{key: out[key]["uN"].movedim(-1, 0).cpu().numpy()
                       for key in ("rom", "srom")}}

        try:
            merged = rom.route_mulocal(mus, run_cell)
        finally:
            self.windows_srom = prev_srom
        self.errors[f"{step}-estimator"] = {
            idx: merged[Errors.ESTIMATOR][idx] for idx in range(len(mus))}
        return merged
