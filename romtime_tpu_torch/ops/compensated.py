"""Compensated (double-word) float arithmetic for the online recursion.

Counterpart of ``romtime_tpu/ops/compensated.py``: the serving state is
carried as an unevaluated sum (hi, lo) of two working-precision words,
and every transformation below is error-free under IEEE rounding of each
individual op. PyTorch's eager CPU and CUDA elementwise kernels round
each op separately (no reassociation, no contraction across ops), which
is what these functions rely on. The CUDA kernel
(``csrc/windowed_fused.cu``) uses the ``__fadd_rn``/``__fmul_rn``
intrinsics for the same reason.
"""

import torch


def two_sum(a, b):
    """a + b = s + e exactly (branch-free Knuth TwoSum)."""
    s = a + b
    ap = s - b
    bp = s - ap
    return s, (a - ap) + (b - bp)


def dd_add_small(hi, lo, delta):
    """(hi, lo) + delta for |delta| ≲ |hi|, renormalized."""
    s, e = two_sum(hi, delta)
    return two_sum(s, e + lo)


def dd_bdf2_predict(u_hi, u_lo, u1_hi, u1_lo):
    """Double-word u_pred = 2·u_n − u_{n-1} (2·x is exact)."""
    ph, pe = two_sum(2.0 * u_hi, -u1_hi)
    pl = pe + (2.0 * u_lo - u1_lo)
    return two_sum(ph, pl)


def dd_history_diff(u_hi, u_lo, u1_hi, u1_lo):
    """Single-word d = u_{n-1} − u_n including the low words."""
    dh, de = two_sum(u1_hi, -u_hi)
    return dh + (de + (u1_lo - u_lo))


def zeros_like_pair(x):
    z = torch.zeros_like(x)
    return z, z


def _split_point(dtype):
    """Dekker splitting constant 2^ceil(p/2)+1 for the mantissa width."""
    return 134217729.0 if dtype == torch.float64 else 4097.0


def two_product(a, b):
    """a·b = p + e exactly (Dekker splitting, no FMA needed)."""
    s = _split_point(a.dtype)
    p = a * b
    ca = s * a
    ah = ca - (ca - a)
    al = a - ah
    cb = s * b
    bh = cb - (cb - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def dd_matvec(T, hi, lo):
    """Double-word matvec (h, l) ≈ T @ (hi + lo).

    T : (n, m) exact in working precision; hi, lo : (m, B). Columns go in
    chunks of 8 wide TwoProducts reduced by a pairwise dd tree, the same
    grouping as the reference (so the rounding sequence matches it)."""
    n, m = T.shape
    B = hi.shape[1]
    CH = 8
    pad = (-m) % CH
    if pad:
        T = torch.cat([T, T.new_zeros((n, pad))], dim=1)
        hi = torch.cat([hi, hi.new_zeros((pad, B))], dim=0)
        lo = torch.cat([lo, lo.new_zeros((pad, B))], dim=0)
        m = m + pad

    def dd_add(ah, al, bh, bl):
        sh, se = two_sum(ah, bh)
        return two_sum(sh, se + al + bl)

    acc_h = hi.new_zeros((n, B))
    acc_l = acc_h
    for c0 in range(0, m, CH):
        Tc = T[:, c0:c0 + CH][:, :, None]        # (n, 8, 1)
        xh = hi[c0:c0 + CH][None, :, :]          # (1, 8, B)
        xl = lo[c0:c0 + CH][None, :, :]
        ph, pe = two_product(Tc, xh)
        pl = pe + Tc * xl
        w = CH
        while w > 1:
            h = w // 2
            ph, pl = dd_add(ph[:, :h], pl[:, :h], ph[:, h:w], pl[:, h:w])
            w = h
        acc_h, acc_l = dd_add(acc_h, acc_l, ph[:, 0], pl[:, 0])
    return two_sum(acc_h, acc_l)
