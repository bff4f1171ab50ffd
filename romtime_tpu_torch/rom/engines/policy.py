"""Serving solve policy (counterpart of the paired-LU and Richardson
switches of ``romtime_tpu/rom/engines/policy.py``).

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
