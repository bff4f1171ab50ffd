"""The legacy generation of the MFP1 heat drivers (counterpart of
``romtime_tpu/problems/mfp1_legacy.py``): thin subclasses of the drivers
in ``rom/hrom.py`` that restore the older surface, an
``evaluate_online`` that takes either sampling ``params`` or an explicit
``mu_space``, with per-μ error-series bookkeeping in ``errors``.

The legacy reporting plots (``plot_spectrums``, ``plot_energy``,
``plot_errors``) are not ported: they wait for the plotting auxiliaries,
and the card's machine has no matplotlib.
"""

from collections import defaultdict

from ..conventions import Stage
from ..rom import hrom as _hrom
from .mfp1 import define_mfp1_problem

__all__ = [
    "HyperReducedOrderModelFixed",
    "HyperReducedOrderModelMoving",
    "define_mfp1_problem",
]


class _LegacyEvaluationMixin:
    """The legacy evaluation surface (reference
    ``problems/mfp1_legacy.py:47-73``)."""

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


class HyperReducedOrderModelFixed(_LegacyEvaluationMixin,
                                  _hrom.HyperReducedOrderModelFixed):
    """Legacy fixed-domain MFP1 driver."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.errors = dict()
        self.summary_errors = defaultdict(dict)


class HyperReducedOrderModelMoving(_LegacyEvaluationMixin,
                                   _hrom.HyperReducedOrderModelMoving):
    """Legacy moving-domain MFP1 driver."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.errors = dict()
        self.summary_errors = defaultdict(dict)
        self.deim_moving_runned = False
