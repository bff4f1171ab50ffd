"""Shared reduction state (counterpart of ``romtime_tpu/rom/base.py``):
every reduction object (the POD constructors and the (M)DEIM family)
keeps its μ-space per stage, a report of the tree walk, and per-μ online
error series.

A stated departure: the reference's error summary is a pandas table
(``rom/base.py:154-163``); the card's machine has no pandas, so
:meth:`Reductor.create_errors_summary` keeps the same four columns per μ
(mean, median, max, min) as a dict of columns, which
``utils.io.write_table`` writes as the table's CSV.
"""

from collections import defaultdict

import numpy as np

from ..conventions import ProblemType, Stage, Treewalk, TreewalkNonlinear
from ..parameters import ParameterSampler

#: The summary's columns, in the reference table's order.
SUMMARY_COLUMNS = ("mean", "median", "max", "min")


class Reductor:

    FOM = ProblemType.FOM
    ROM = ProblemType.ROM

    BASIS_AFTER_WALK = Treewalk.BASIS_AFTER_WALK
    BASIS_FINAL = Treewalk.BASIS_FINAL
    BASIS_TIME = Treewalk.BASIS_TIME
    ENERGY_MU = Treewalk.ENERGY_MU
    ENERGY_TIME = Treewalk.ENERGY_TIME
    SPECTRUM_MU = Treewalk.SPECTRUM_MU
    SPECTRUM_TIME = Treewalk.SPECTRUM_TIME

    def __init__(self, grid=None) -> None:
        """``grid`` maps μ names to distributions (``.rvs``) or lists, as
        the port's :class:`~romtime_tpu_torch.parameters.ParameterSampler`
        takes them."""
        self.grid = grid
        self.mu_space = {
            Stage.OFFLINE: list(),
            Stage.ONLINE: list(),
            Stage.VALIDATION: list(),
        }
        self.report = defaultdict(dict)
        self.errors_rom = defaultdict(list)
        self.summary_errors = None
        self.mu = None
        self.random_state = None

    def add_mu(self, step, mu):
        """Register a μ for a stage; returns (its index, μ). The index is
        the appended position, as the reference's deviation note says
        (``rom/base.py:75-96``): ``list.index`` would alias a duplicate μ
        to its first slot."""
        self.mu_space[step].append(mu)
        self.mu = mu
        return len(self.mu_space[step]) - 1, mu

    def build_sampling_space(self, num, rnd=None):
        """Random μ sampler over the grid (reference
        ``rom/base.py:98-120``)."""
        return ParameterSampler(param_distributions=self.grid, n_iter=num,
                                random_state=rnd)

    def setup(self, rnd=None):
        """Initialize the tree-walk report slots (reference
        ``rom/base.py:122-152``)."""
        self.random_state = rnd
        offline = self.report[Stage.OFFLINE]
        for walk in (Treewalk, TreewalkNonlinear):
            offline[walk.BASIS_AFTER_WALK] = None
            offline[walk.BASIS_FINAL] = None
            offline[walk.SPECTRUM_MU] = None
            offline[walk.ENERGY_MU] = None
            offline[walk.BASIS_TIME] = dict()
            offline[walk.SPECTRUM_TIME] = dict()
            offline[walk.ENERGY_TIME] = dict()

    def create_errors_summary(self):
        """Mean, median, max and min of each μ's error series (reference
        ``rom/base.py:154-163``): ``summary_errors`` maps each column to a
        list over the μ indices, ``summary_errors["index"]`` those
        indices (the reference's DataFrame rows)."""
        index = list(self.errors_rom)
        reducers = dict(zip(SUMMARY_COLUMNS,
                            (np.mean, np.median, np.max, np.min)))
        self.summary_errors = {"index": index, **{
            col: [float(fn(self.errors_rom[i])) for i in index]
            for col, fn in reducers.items()}}
        return self.summary_errors
