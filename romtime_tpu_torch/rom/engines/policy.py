"""Serving policy (counterpart of ``romtime_tpu/rom/engines/policy.py``
and of the precompute constants of ``romtime_tpu/rom/rom.py:96-98``).

Stage 2 of windowed serving takes one of three branches, as the
reference's does (``windowed_pallas.py:310-488``): materialized operator
tables and one K2 launch per window while the tables fit the precompute
budget (:class:`PrecomputePolicy`), otherwise the θ-streaming sweep that
``ROMTIME_WINDOWED_KERNEL`` names (:func:`windowed_kernel`): the fused K1
by default, or a K3 launch per window. The global engine takes K4 over
materialized tables or K5 on the same test.

The fused sweep solves each step with a pivot-free LU. By default it
reuses one factorization per group of ``WINDOWED_PAIRED_LU`` steps
(mode ``"sub1"``: the followers substitute with the leader's factors and
refine once against their own matrix). Richardson iteration and the
other follower modes are not ported: asking for them raises instead of
being ignored.
"""

import os

WINDOWED_PAIRED_LU = 5
WINDOWED_PAIRED_MODE = "sub1"
PORTED_PAIRED_MODES = ("sub1", "off")


class PrecomputePolicy:
    """Matrices-vs-θ choice of the serving engines (reference
    ``SolvePolicyMixin._precompute_choice``): the measured override that
    ``autotune_online_precompute`` or ``load_autotune`` pins wins, bounded
    by the hard cap; otherwise the static byte budget. The budget and the
    cap stay the reference's 6 and 12 GiB so that the port routes as the
    reference routes, although the card holds 80 GB."""

    ONLINE_PRECOMPUTE = "matrices"
    ONLINE_PRECOMPUTE_BUDGET = 6 * 1024**3       # bytes
    ONLINE_PRECOMPUTE_HARD_CAP = 12 * 1024**3    # bytes
    _precompute_override = None                  # "matrices" | "thetas"

    def precompute_choice(self, mat_bytes):
        """True → materialize the operator time tables (``mat_bytes`` of
        them) and sweep over them (K2 per window, or K4)."""
        override = self._precompute_override
        if override is not None:
            return (override == "matrices"
                    and mat_bytes <= self.ONLINE_PRECOMPUTE_HARD_CAP)
        return (self.ONLINE_PRECOMPUTE == "matrices"
                and mat_bytes <= self.ONLINE_PRECOMPUTE_BUDGET)


def windowed_kernel():
    """θ-streaming kernel generation, read from ``ROMTIME_WINDOWED_KERNEL``
    as the reference reads it: ``"fused"`` (the default, K1) or, for any
    other value, ``"v2"`` (K3 launches per window)."""
    if os.environ.get("ROMTIME_WINDOWED_KERNEL", "fused") == "fused":
        return "fused"
    return "v2"


def windowed_paired_lu():
    """Group size (≥ 2) or None; ``ROMTIME_PAIRED_LU`` overrides."""
    env = os.environ.get("ROMTIME_PAIRED_LU")
    if env is not None and env != "":
        n = int(env)
        return n if n >= 2 else None
    return WINDOWED_PAIRED_LU


def windowed_paired_mode():
    """Follower mode; ``ROMTIME_PAIRED_MODE`` overrides. Raises for a
    mode this port does not have."""
    mode = os.environ.get("ROMTIME_PAIRED_MODE", WINDOWED_PAIRED_MODE)
    if mode not in PORTED_PAIRED_MODES:
        raise NotImplementedError(
            f"paired-LU follower mode {mode!r} is not ported "
            f"(ported: {', '.join(PORTED_PAIRED_MODES)})")
    return mode


def windowed_solve_iters():
    """Richardson iterations: not ported. ``ROMTIME_SOLVE_ITERS`` > 0
    raises; unset or 0 selects the LU (None)."""
    env = os.environ.get("ROMTIME_SOLVE_ITERS")
    if env is not None and env != "" and int(env) > 0:
        raise NotImplementedError(
            "Richardson solve (ROMTIME_SOLVE_ITERS > 0) is not ported; "
            "unset it or set 0 for the LU")
    return None


def windowed_solve_group():
    """(group, mode) for the fused sweep: group None means per-step LU."""
    windowed_solve_iters()
    mode = windowed_paired_mode()
    if mode == "off":
        return None, "sub1"
    return windowed_paired_lu(), mode
