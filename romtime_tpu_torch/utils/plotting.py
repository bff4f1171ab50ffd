"""Plotting helpers (counterpart of ``romtime_tpu/utils/plotting.py``):
the solution and snapshot views of a FOM, error series, singular-value
spectra and the online (M)DEIM errors. matplotlib is imported inside
:func:`_plt`, at the first plot, under the Agg backend; the card's
machine has none, and nothing of the serving or build paths plots."""

import numpy as np

from ..conventions import FIG_KWARGS


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def plot_solution(solutions, pics=6, save=None, scale=1.0, title="Solution"):
    """About ``pics`` snapshots of u(x, t) over the (moving) domain:
    ``solutions.domain`` and ``solutions.fom`` (nh, nt) (reference
    ``plotting.py:21-44``)."""
    plt = _plt()
    plt.figure()
    domain = solutions.domain
    fom = solutions.fom
    nt = domain.shape[1]
    step = max(1, nt // pics)
    for t in range(0, nt, step):
        plt.plot(domain[:, t], scale * fom[:, t], c="b")
    plt.grid()
    plt.xlabel("$x$")
    plt.ylabel("$u(x,t)$")
    plt.title(title)
    if save:
        plt.savefig(save, **FIG_KWARGS)
        plt.close()
    else:
        plt.show()


def plot_errors(ts, errors, save=None, log=False, label=None, new=True):
    """An error time series (reference ``plotting.py:47-65``)."""
    plt = _plt()
    if new:
        plt.figure()
    errors = np.asarray(errors)
    if log:
        errors = np.log10(errors)
    plt.plot(ts, errors, label=label)
    plt.grid()
    plt.xlabel("$t$")
    plt.ylabel("L2 norm")
    plt.title("Errors")
    if save:
        plt.savefig(save, **FIG_KWARGS)
        plt.close()


def plot_spectrum(sigmas, energy=None, save=None, title="Spectrum decay"):
    """The singular-value decay σᵢ/σ₁ and, given ``energy``, 1 − the
    cumulative energy (reference ``plotting.py:68-87``)."""
    plt = _plt()
    plt.figure()
    sigmas = np.asarray(sigmas)
    plt.semilogy(sigmas / sigmas[0], "o-", label="$\\sigma_i/\\sigma_1$")
    if energy is not None:
        plt.semilogy(1.0 - np.asarray(energy) + 1e-18, "s--",
                     label="1 - energy")
    plt.grid(True)
    plt.xlabel("$i$-th mode")
    plt.legend()
    plt.title(title)
    if save:
        plt.savefig(save, **FIG_KWARGS)
        plt.close()


def plot_deim_errors(deim, save=None, show=False):
    """The online (M)DEIM error series of each μ in ``deim.errors_rom``
    over the tree walk's times (reference ``plotting.py:90-109``)."""
    plt = _plt()
    plt.figure()
    ts = deim.tree_walk_params["ts"]
    for error in deim.errors_rom.values():
        if np.size(error):
            plt.plot(ts[: len(error)], np.log10(np.asarray(error)))
    plt.grid(True)
    plt.xlabel("$t$")
    plt.ylabel("log10 L2 error")
    plt.title(f"(M)DEIM {str(deim.name).title()} online errors")
    if save:
        plt.savefig(save, **FIG_KWARGS)
        plt.close()
    elif show:
        plt.show()
