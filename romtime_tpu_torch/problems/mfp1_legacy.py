"""The legacy generation of the MFP1 heat drivers (counterpart of
``romtime_tpu/problems/mfp1_legacy.py``): thin subclasses of the drivers
in ``rom/hrom.py`` that restore the older surface, an
``evaluate_online`` that takes either sampling ``params`` or an explicit
``mu_space``, with per-μ error-series bookkeeping in ``errors``.

The legacy reporting plots (``plot_spectrums``, ``plot_energy``,
``plot_errors``) import matplotlib at their first call; the card's
machine has none, and nothing else of the drivers plots.
"""

from collections import defaultdict

import numpy as np

from ..conventions import FIG_KWARGS, Stage
from ..rom import hrom as _hrom
from .mfp1 import define_mfp1_problem

__all__ = [
    "HyperReducedOrderModelFixed",
    "HyperReducedOrderModelMoving",
    "define_mfp1_problem",
]


class _LegacyReportingMixin:
    """The legacy evaluation surface and reporting plots (reference
    ``problems/mfp1_legacy.py:41-171``)."""

    FIG_KWARGS = FIG_KWARGS

    def evaluate_online(self, params=None, mu_space=None, rnd=None):
        """Online evaluation over a sampled set (``params["num"]``, its
        ``"rnd"`` or ``rnd``) or an explicit parameter list
        (``mu_space``): each μ solved by the ROM, its error series against
        the manufactured exact solution kept; returns ``errors``, μ index
        → series."""
        self.online_params = params
        rom = self.rom
        if params:
            space = rom.build_sampling_space(num=params["num"],
                                             rnd=params.get("rnd", rnd))
        elif mu_space is not None:
            space = mu_space
        else:
            raise ValueError("evaluate_online needs params or mu_space")
        for mu in space:
            rom.solve(mu=mu, step=Stage.ONLINE)
        self.errors = dict(rom.errors)
        return self.errors

    # ------------------------------------------------------------------
    # Reporting plots (reference problems/mfp1_legacy.py:74-171)
    # ------------------------------------------------------------------
    def plot_spectrums(self, save=None, new=True, show=False):
        """log10 of each operator's μ-stage spectrum, from
        ``summary_sigmas``; saved to ``save + ".png"``."""
        from ..utils.plotting import _plt

        plt = _plt()
        if new:
            plt.figure()
        for element, sigmas_dict in self.summary_sigmas.items():
            sigma = sigmas_dict.get(self.rom.SPECTRUM_MU)
            if sigma is None:
                continue
            sigma = np.asarray(sigma)
            plt.plot(np.log10(np.maximum(sigma, 1e-300)), label=str(element))
        plt.xlabel("Up to n-th basis element")
        plt.ylabel("$\\log (\\sigma)$")
        plt.title("Spectrum decay in the parameter space")
        plt.legend()
        plt.grid(True)
        self._finish_plot(plt, save, show)

    def plot_energy(self, save=None, show=False):
        """Each operator's μ-stage POD energy ratio, from
        ``summary_energy``."""
        from ..utils.plotting import _plt

        plt = _plt()
        for element, energy in self.summary_energy.items():
            ratio = energy.get(self.rom.ENERGY_MU)
            if ratio is None:
                continue
            plt.plot(np.asarray(ratio), label=str(element))
        plt.xlabel("Up to n-th basis element")
        plt.ylabel("Ratio")
        plt.title("Total POD Energy Ratio")
        plt.legend()
        plt.grid(True)
        self._finish_plot(plt, save, show)

    def plot_errors(self, save=None, new=True, label=None, show=False):
        """log10 of the ROM's online error series, one curve a μ, over
        the last steps of the time grid."""
        from ..utils.plotting import _plt

        plt = _plt()
        if new:
            plt.figure()
        rom = self.rom
        ts = np.asarray(rom.timesteps)
        for error in rom.errors.values():
            error = np.asarray(error)
            n = min(len(error), len(ts))
            plt.plot(ts[len(ts) - n:],
                     np.log10(np.maximum(error[-n:], 1e-300)),
                     linewidth=1.0, alpha=0.85, label=label)
        plt.xlabel("t")
        plt.ylabel("log10 Error (L2)")
        plt.title("Online Errors")
        if label:
            plt.legend()
        plt.grid(True)
        self._finish_plot(plt, save, show)

    def _finish_plot(self, plt, save, show):
        if save:
            plt.savefig(str(save) + ".png", **self.FIG_KWARGS)
        if show:
            plt.show()
        plt.close("all")


class HyperReducedOrderModelFixed(_LegacyReportingMixin,
                                  _hrom.HyperReducedOrderModelFixed):
    """Legacy fixed-domain MFP1 driver."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.errors = dict()
        self.summary_errors = defaultdict(dict)


class HyperReducedOrderModelMoving(_LegacyReportingMixin,
                                   _hrom.HyperReducedOrderModelMoving):
    """Legacy moving-domain MFP1 driver."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.errors = dict()
        self.summary_errors = defaultdict(dict)
        self.deim_moving_runned = False
