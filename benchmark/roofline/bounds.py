"""Least time of the sweep kernels on one H100, from the cell's shapes
alone: the operations and bytes a sweep needs, against the card's
published FP32 and HBM peaks (a frozen copy of the bound arithmetic of
``chip_smoke.py``'s ``k1_bound`` and ``k4_bound``).

Both count the real n×n block of the operators (the padded rows and
columns hold zeros and the identity, no work), the θ rows that feed it
(``km``, ``kk``, ``kf``: the live mass, stiffness-side and right-hand
side rows, 8 DEIM dofs a source), the ``p`` real probe rows and the
trilinear term, one fused multiply-add as two operations.
"""

#: Published peaks of one NVIDIA H100 SXM (FP32 outside the tensor
#: cores, HBM3), at its 700 W limit.
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def lu_fmas(n):
    """FMAs of one lane's pivot-free LU of an n×n matrix and its two
    triangular solves."""
    return sum((n - k - 1) * (n - k) for k in range(n)) + n * n


def step_fmas(n, km, kk, kf, with_trilinear, solve, p):
    """FMAs of one lane's residual BDF step with each operator formed
    once from its live θ rows: MN, KL (n²·(km + kk)), fN (n·kf), the
    trilinear N = T·pred and its scale (n³ + n²), KN, MN·d and the
    stiffness·pred product (3·n²), the solve and the p probes (p·n)."""
    tri = n ** 3 + n * n if with_trilinear else 0
    return n * n * (km + kk) + n * kf + tri + 3 * n * n + solve + p * n


def global_step_fmas(n, with_trilinear, p):
    """FMAs of one lane's plain-f32 global step over materialized
    operators: the trilinear N = T·u* (n³) and its scaled add (n²), KN
    and MN·combo (2·n²), the LU solve and the p probes."""
    tri = n ** 3 + n * n if with_trilinear else 0
    return tri + 2 * n * n + lu_fmas(n) + p * n


def stream_words(nt, B, n, p, with_trilinear, carry):
    """Float32 words every sweep reads and writes beside its operators:
    the lifting probes in and the probes out (p rows a step), the
    trilinear table (n³), the probe rows, b0 and the state (the double
    word carry in and out, 4 rows each, or the final state out)."""
    return (2 * nt * p * B + (n ** 3 if with_trilinear else 0) + p * n
            + B + (2 * 4 * n * B if carry else n * B))


def least_seconds(flops, nbytes):
    """(seconds, "operations" or "bytes"): the larger of the two times."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def k1_seconds(nt, W, n, B, km, kk, kf, p, with_trilinear=True):
    """K1, the fused windowed sweep with the per-step LU, over W windows
    of nt/W steps: per step :func:`step_fmas`, per window the two double
    word transfers of the carry (~10 operations an entry); bytes: the
    live θ rows and the real lifting rows, per window the live combine
    rows on the real block, the trilinear table, the transfer and the
    probe rows."""
    per_step = step_fmas(n, km, kk, kf, with_trilinear, lu_fmas(n), p)
    per_window = 2 * 10 * n * n
    flops = 2 * B * (nt * per_step + W * per_window)
    words = (nt * (km + kk + kf) * B
             + W * (n * n * (km + kk) + n * kf + n * n)
             + stream_words(nt, B, n, p, with_trilinear, True)
             + (W - 1) * ((n ** 3 if with_trilinear else 0) + p * n))
    return least_seconds(flops, 4 * words)


def k4_seconds(nt, n, B, p, with_trilinear=True):
    """K4, the global sweep over materialized MN, KL (n² each) and fN (n)
    per step and lane."""
    flops = 2 * B * nt * global_step_fmas(n, with_trilinear, p)
    words = (nt * (2 * n * n + n) * B
             + stream_words(nt, B, n, p, with_trilinear, False))
    return least_seconds(flops, 4 * words)
