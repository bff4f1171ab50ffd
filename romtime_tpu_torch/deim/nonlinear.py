"""Nonlinear (state-dependent) MDEIM reductor, serving subset
(counterpart of ``romtime_tpu/deim/nonlinear.py``). Windowed serving
applies the trilinear operator through its exact per-window table, so
this reductor is only needed to assemble N(u) at its entries for a given
state."""

from .mdeim import MatrixDiscreteEmpiricalInterpolation


class MatrixDiscreteEmpiricalInterpolationNonlinear(
        MatrixDiscreteEmpiricalInterpolation):

    TYPE = "N-MDEIM"

    def _entries_traced(self, mu, t, u_n=None):
        return self.assemble(mu=mu, t=t, entries=self.dofs, u_n=u_n)
