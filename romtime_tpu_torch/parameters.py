"""Parameter-space sampling (counterpart of ``romtime_tpu/parameters.py``).

A grid maps parameter names to frozen scipy uniforms
(:func:`get_uniform_dist`) or finite lists. Samples come from a
``numpy.random.RandomState`` stream with the keys iterated in sorted
order, which is what makes the stream equal to sklearn's
``ParameterSampler`` (and the reference's) draw for draw. Pure numpy; scipy
is imported only by :func:`get_uniform_dist`.
"""

import numpy as np


def get_uniform_dist(min, max):
    """Frozen U[min, max] distribution (reference ``parameters.py:19-23``)."""
    from scipy.stats.distributions import uniform

    return uniform(loc=min, scale=max - min)


def round_parameters(sample, num=2):
    """Round a single parameter dict."""
    return dict((k, round(v, num)) for (k, v) in sample.items())


def round_parameter_list(param_list, num=2):
    """Round a list of parameter dicts."""
    return [round_parameters(d, num) for d in param_list]


def check_random_state(seed):
    """``seed`` as a ``numpy.random.RandomState``: None (fresh state), an
    int or a RandomState, the contract sklearn uses."""
    if seed is None:
        return np.random.RandomState()
    if isinstance(seed, (int, np.integer)):
        return np.random.RandomState(seed)
    if isinstance(seed, np.random.RandomState):
        return seed
    raise ValueError(f"Cannot build a RandomState from {seed!r}.")


class ParameterSampler:
    """Random sampler over a dict of distributions or lists (reference
    ``parameters.py:52-86``): ``n_iter`` dicts, keys in sorted order, a
    uniform drawn as its ``.rvs(random_state=rng)`` draws (:func:`_draw`),
    a list indexed by ``rng.randint``."""

    def __init__(self, param_distributions, n_iter, random_state=None):
        self.param_distributions = param_distributions
        self.n_iter = int(n_iter)
        self.random_state = random_state

    def __len__(self):
        return self.n_iter

    def __iter__(self):
        rng = check_random_state(self.random_state)
        items = sorted(self.param_distributions.items())
        for _ in range(self.n_iter):
            sample = dict()
            for key, value in items:
                if hasattr(value, "rvs"):
                    sample[key] = _draw(value, rng)
                else:
                    sample[key] = value[rng.randint(len(value))]
            yield sample


def _draw(dist, rng):
    """One draw of the frozen uniform ``dist`` from ``rng``, as scipy's
    ``rvs`` draws it: u·scale + loc from one ``rng.uniform(0, 1)``, and
    nothing drawn for a zero scale (loc). Drawn here without scipy's
    per-call overhead (~27 µs: a fleet's candidate pool takes 10⁵-10⁶
    draws). Raises ``ValueError`` for any other distribution: every μ box
    of the port is uniform."""
    kwds = getattr(dist, "kwds", None)
    if (getattr(getattr(dist, "dist", None), "name", None) != "uniform"
            or dist.args or not set(kwds) <= {"loc", "scale"}):
        raise ValueError(f"the sampler draws frozen uniforms "
                         f"(get_uniform_dist) only, not {dist!r}")
    loc = float(kwds.get("loc", 0.0))
    scale = float(kwds.get("scale", 1.0))
    if scale == 0.0:
        return np.float64(loc)
    return np.float64(rng.uniform(0.0, 1.0) * scale + loc)


def sample_parameters(grid, num, random_state=None):
    """``num`` samples from ``grid`` as a list of dicts."""
    return list(ParameterSampler(grid, n_iter=num, random_state=random_state))


def parameters_to_array(mu_list, names=None):
    """Stack parameter dicts into a (num, n_params) array, columns in
    ``names`` order (default: sorted keys); returns (array, names)."""
    if names is None:
        names = sorted(mu_list[0].keys())
    arr = np.array([[float(mu[name]) for name in names] for mu in mu_list])
    return arr, list(names)


def array_to_parameters(arr, names):
    """Inverse of :func:`parameters_to_array`."""
    return [dict(zip(names, row)) for row in np.asarray(arr)]
