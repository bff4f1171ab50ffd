"""μ-local (Mach-cell) routed serving over a fleet of windowed
configurations (counterpart of ``romtime_tpu/rom/engines/mulocal.py``):
mixin methods of :class:`~romtime_tpu_torch.rom.rom.RomConstructorNonlinear`.
"""

import numpy as np

from ...conventions import Stage


class MuLocalRoutingMixin:
    """Needs ``self.mulocal`` (a
    :class:`~romtime_tpu_torch.rom.windowed.MuLocalWindowed` or None),
    ``self.windows``, ``_set_serving_windows``, ``solve_batch`` and
    ``compute_piston_mach_number``."""

    def solve_batch_mulocal(self, mus, step=Stage.ONLINE, mode="probes",
                            engine=None, sweep_fn=None):
        """Route each μ to its Mach cell's windowed tables and serve
        (reference ``mulocal.py:46-75``). Each cell's sub-batch is padded
        to the full batch by cycling its own μ, so a call runs one
        full-batch sweep per occupied cell; outputs are merged back in
        input order, batch-first. ``sweep_fn(mus) -> outs`` overrides the
        per-cell sweep (default: ``solve_batch`` with the given step, mode
        and engine)."""
        def run_cell(_c, sub):
            if sweep_fn is not None:
                return sweep_fn(sub)
            return self.solve_batch(sub, step=step, mode=mode, engine=engine)

        return self.route_mulocal(mus, run_cell)

    def route_mulocal(self, mus, run_cell):
        """The μ-local router (reference ``mulocal.py:77-138``): group the
        μ by Mach cell, run ``run_cell(cell_index, sub_mus)`` with that
        cell attached (the sub-batch padded to the full length by cycling
        its own μ), and merge the batch-first rows back in input order.
        The serving windows of before the call are restored. Mixed
        registration: rows a cell did not emit take ``dil`` 1.0,
        ``dil_oor`` 0.0, or the shared value another cell passed through;
        mixed (W, N): a key whose rows differ in shape stays a list of
        rows."""
        ml = self.mulocal
        if ml is None:
            raise ValueError("no μ-local serving attached — load one with "
                             "convert.fleet_serving_from_arrays")
        mach = np.array([self.compute_piston_mach_number(mu) for mu in mus])
        cells = np.asarray(ml.cell_of(mach))
        n = len(mus)
        prev = self.windows
        rows = {}      # batch-first keys: per-index rows, merged below
        passthru = {}  # non-batch keys: the first cell's value
        try:
            for c in sorted(set(cells.tolist())):
                idx = np.nonzero(cells == c)[0]
                sub = [dict(mus[int(i)]) for i in idx]
                sub = (sub * -(-n // len(sub)))[:n]
                self._set_serving_windows(ml.cells[int(c)])
                outs = run_cell(int(c), sub)
                for k, v in outs.items():
                    if np.ndim(v) >= 1 and len(v) == n:
                        slot = rows.setdefault(k, [None] * n)
                        for j, i in enumerate(idx):
                            slot[int(i)] = np.asarray(v[j])
                    elif k not in passthru:
                        passthru[k] = np.copy(v)
        finally:
            self._set_serving_windows(prev)
        merged = dict(passthru)
        for k, lst in rows.items():
            if any(r is None for r in lst):
                if k == "dil":
                    fill = np.asarray(1.0)
                elif k == "dil_oor":
                    fill = np.asarray(0.0)
                elif k in passthru:
                    fill = np.asarray(passthru[k])
                else:
                    raise ValueError(
                        f"μ-local merge: output '{k}' missing for some "
                        "cells and no shared fallback value exists")
                lst = [fill if r is None else r for r in lst]
            shapes = {r.shape for r in lst}
            merged[k] = np.stack(lst) if len(shapes) == 1 else lst
        return merged
