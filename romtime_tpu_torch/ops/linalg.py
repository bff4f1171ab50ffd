"""Direct solves (counterpart of ``romtime_tpu/ops/linalg.py``): the
banded FOM systems by parallel cyclic reduction (tridiagonal, p = 1) and
block cyclic reduction (2 ≤ p ≤ 5), Thomas on request, dense above; the
unrolled Gauss-Jordan of the DEIM θ-systems and the batch-last
elimination of the lanes engines. Banded solves take leading batch axes,
band (..., 2p+1, nh) and rhs (..., nh), broadcast as in the reference.
No pivoting: the BDF systems are diagonally dominant."""

import math

import torch
import torch.nn.functional as F

from .assembly import band_to_dense


def tridiag_solve(band, rhs):
    """Thomas algorithm for tridiagonal A in banded storage (..., 3, nh):
    band[..., 0, r] = A[r, r-1], band[..., 1, r] = A[r, r], band[..., 2,
    r] = A[r, r+1]. A sequential sweep over the rows (the reference's
    ``lax.scan``), one set of small ops per row."""
    shape = torch.broadcast_shapes(band.shape[:-2] + band.shape[-1:],
                                   rhs.shape)
    lower, diag, upper = (band[..., i, :].expand(shape) for i in range(3))
    rhs = rhs.expand(shape)
    n = shape[-1]
    c_prev = d_prev = rhs.new_zeros(shape[:-1])
    cs, ds = [], []
    for i in range(n):
        m = diag[..., i] - lower[..., i] * c_prev
        c_prev = upper[..., i] / m
        d_prev = (rhs[..., i] - lower[..., i] * d_prev) / m
        cs.append(c_prev)
        ds.append(d_prev)
    x_next = rhs.new_zeros(shape[:-1])
    xs = [None] * n
    for i in reversed(range(n)):
        x_next = ds[i] - cs[i] * x_next
        xs[i] = x_next
    return torch.stack(xs, dim=-1)


def tridiag_solve_pcr(band, rhs):
    """Parallel cyclic reduction for tridiagonal systems: ceil(log2 nh)
    elementwise reduction levels over the whole grid, the reference's
    ``ops/linalg.py:60-107`` op for op. Out-of-range neighbours act as
    identity rows (b=1, a=c=d=0). Each level pads the diagonal once and
    the other three once, stacked, for both shifts (fewer launches, the
    same values)."""
    a = band[..., 0, :]
    b = band[..., 1, :]
    c = band[..., 2, :]
    d = rhs
    n = rhs.shape[-1]
    steps = max(1, int(math.ceil(math.log2(n))))
    for k in range(steps):
        s = 1 << k
        b_pad = F.pad(b, (s, s), value=1.0)
        acd = F.pad(torch.stack(torch.broadcast_tensors(a, c, d)), (s, s))
        b_m, b_p = b_pad[..., :n], b_pad[..., 2 * s:]   # v[i-s], v[i+s]
        a_m, c_m, d_m = acd[..., :n]
        a_p, c_p, d_p = acd[..., 2 * s:]

        alpha = -a / b_m
        gamma = -c / b_p

        a = alpha * a_m
        c = gamma * c_p
        b = b + alpha * c_m + gamma * a_p
        d = d + alpha * d_m + gamma * d_p
    return d / b


def _gauss_solve_matrix(A, B):
    """Unpivoted Gauss-Jordan with a matrix right-hand side: A (..., N,
    N), B (..., N, K) → X (..., N, K)."""
    N = A.shape[-1]
    M = torch.cat([A, B], dim=-1)
    row_ids = torch.arange(N, device=A.device)
    for k in range(N):
        is_k = (row_ids == k)[:, None]
        pivot_row = M[..., k:k + 1, :]
        pivot_row = pivot_row / pivot_row[..., 0:1, k:k + 1]
        factor = M[..., :, k:k + 1]
        M = torch.where(is_k, pivot_row, M - factor * pivot_row)
    return M[..., :, N:]


def block_tridiag_from_band(band, p):
    """View a half-bandwidth-p banded matrix (..., 2p+1, nh) as block
    tridiagonal with p×p blocks: returns (A, B, C, m, pad), the sub,
    diagonal and super block stacks (..., m, p, p), the matrix padded by
    identity rows to m·p dofs."""
    nh = band.shape[-1]
    m = -(-nh // p)
    pad = m * p - nh
    if pad:
        band = torch.cat([band, band.new_zeros(band.shape[:-1] + (pad,))],
                         dim=-1)
        band[..., p, nh:] = 1.0

    def blocks(j_of):
        cols = []
        for a in range(p):
            row = []
            for b in range(p):
                j = j_of(a, b)
                if 0 <= j <= 2 * p:
                    row.append(band[..., j, a::p])
                else:
                    row.append(torch.zeros_like(band[..., 0, a::p]))
            cols.append(torch.stack(row, dim=-1))     # (..., m, p)
        return torch.stack(cols, dim=-2)              # (..., m, p, p)

    B = blocks(lambda a, b: p + b - a)
    A = blocks(lambda a, b: b - a)             # offset −p block
    C = blocks(lambda a, b: 2 * p + b - a)     # offset +p block
    return A, B, C, m, pad


def block_tridiag_solve_pcr(A, B, C, D):
    """Block parallel cyclic reduction of A_i X_{i-1} + B_i X_i + C_i
    X_{i+1} = D_i: A, B, C (..., m, p, p), D (..., m, p) → X (..., m, p);
    out-of-range neighbours act as identity rows, as in the scalar PCR."""
    m = B.shape[-3]
    p = B.shape[-1]
    eye = torch.eye(p, dtype=B.dtype, device=B.device)
    D = D[..., None]

    def shifted(v, s, identity=False):
        """v[i-s] along the block axis."""
        n = abs(s)
        fill_shape = v.shape[:-3] + (n,) + v.shape[-2:]
        fill = (eye.expand(fill_shape) if identity
                else v.new_zeros(fill_shape))
        if s > 0:
            return torch.cat([fill, v[..., :m - s, :, :]], dim=-3)
        return torch.cat([v[..., n:, :, :], fill], dim=-3)

    steps = max(1, int(math.ceil(math.log2(m)))) if m > 1 else 0
    for k in range(steps):
        s = 1 << k
        B_m = shifted(B, s, identity=True)
        B_p = shifted(B, -s, identity=True)
        A_m = shifted(A, s)
        C_p = shifted(C, -s)
        C_m = shifted(C, s)
        A_p = shifted(A, -s)
        D_m = shifted(D, s)
        D_p = shifted(D, -s)

        alpha = -_gauss_solve_matrix(B_m.transpose(-1, -2),
                                     A.transpose(-1, -2)).transpose(-1, -2)
        gamma = -_gauss_solve_matrix(B_p.transpose(-1, -2),
                                     C.transpose(-1, -2)).transpose(-1, -2)

        A = alpha @ A_m
        C = gamma @ C_p
        B = B + alpha @ C_m + gamma @ A_p
        D = D + alpha @ D_m + gamma @ D_p
    return _gauss_solve_matrix(B, D)[..., 0]


def solve_banded_block_pcr(band, rhs, p):
    """Banded direct solve by block cyclic reduction (p ≤ 5); band
    (..., 2p+1, nh) broadcasts against rhs (..., nh)."""
    batch = torch.broadcast_shapes(band.shape[:-2], rhs.shape[:-1])
    nh = rhs.shape[-1]
    band = band.expand(batch + band.shape[-2:])
    rhs = rhs.expand(batch + (nh,))
    A, B, C, m, pad = block_tridiag_from_band(band, p)
    if pad:
        rhs = torch.cat([rhs, rhs.new_zeros(batch + (pad,))], dim=-1)
    X = block_tridiag_solve_pcr(A, B, C, rhs.reshape(batch + (m, p)))
    return X.reshape(batch + (m * p,))[..., :nh]


def solve_banded(band, rhs, p, method=None):
    """Direct solve with a half-bandwidth-p banded matrix: PCR for p = 1
    (``method="thomas"`` for the sequential sweep), block PCR for
    2 ≤ p ≤ 5, a dense solve above (or with ``method="dense"``)."""
    if p == 1:
        if method is None:
            method = "pcr"
        if method == "pcr":
            return tridiag_solve_pcr(band, rhs)
        return tridiag_solve(band, rhs)
    if p <= 5 and method != "dense":
        return solve_banded_block_pcr(band, rhs, p)
    dense = band_to_dense(band, p)
    return torch.linalg.solve(dense, rhs[..., None])[..., 0]


def solve_dense_batch(mats, rhs):
    """Batched dense solve of the reduced N×N systems: mats (..., N, N),
    rhs (..., N)."""
    return gauss_solve(mats, rhs)


def gauss_solve(A, b, pivot=True):
    """Batched dense solve by unrolled Gauss-Jordan (reference
    ``linalg.py:296``), with partial pivoting unless ``pivot=False``
    (the online systems and DEIM's PᵀU admit elimination without it).
    Each pivot row is normalized as it goes, so the solution is the last
    column of the augmented system.

    A: (..., N, N), b: (..., N) -> x: (..., N)."""
    N = A.shape[-1]
    M = torch.cat([A.to(b.dtype).expand(b.shape[:-1] + (N, N)),
                   b[..., :, None]], dim=-1)          # (..., N, N+1)
    row_ids = torch.arange(N, device=b.device)
    for k in range(N):
        is_k = (row_ids == k)[:, None]
        if pivot:
            col = M[..., :, k].abs()
            col = torch.where(row_ids >= k, col,
                              torch.full_like(col, -float("inf")))
            piv = col.argmax(dim=-1)                   # (...,)
            onehot = (row_ids == piv[..., None])       # (..., N)
            row_p = torch.einsum("...r,...rc->...c", onehot.to(M.dtype),
                                 M)[..., None, :]
            row_k = M[..., k:k + 1, :]
            M = torch.where(is_k, row_p,
                            torch.where(onehot[..., :, None], row_k, M))
        pivot_row = M[..., k:k + 1, :]
        pivot_row = pivot_row / pivot_row[..., 0:1, k:k + 1]
        factor = M[..., :, k:k + 1]
        M = torch.where(is_k, pivot_row, M - factor * pivot_row)
    return M[..., :, N]


def gauss_solve_lanes(A, b):
    """Batched dense solve with the μ batch in the last (lane) axis
    (reference ``linalg.py:351``): unpivoted Gauss-Jordan on the
    augmented (N, N+1, B) system, normalizing each pivot row as it goes so
    the solution is the last column. No pivoting: the online systems are
    M-dominant (the serving object's cond₂ guard certifies it), and
    ``torch.linalg.solve`` would pivot and round differently.

    A: (N, N) shared or (N, N, B); b: (N, B) -> x: (N, B)."""
    N = A.shape[0]
    if A.ndim == 2:
        A = A[:, :, None].expand(N, N, b.shape[-1]).to(b.dtype)
    M = torch.cat([A, b[:, None, :]], dim=1)          # (N, N+1, B)
    for k in range(N):
        pivot_row = M[k] / M[k, k][None, :]           # (N+1, B)
        # Every row eliminated in place, then row k replaced by the
        # normalized pivot row: the reference's select, in fewer launches.
        M -= M[:, k][:, None, :] * pivot_row[None, :, :]
        M[k] = pivot_row
    return M[:, N, :]


def solve_small(A, b):
    """Shape-dispatching small dense solve of the DEIM θ-systems
    (reference ``linalg.py:378``): b (N,) → :func:`gauss_solve` (pivoted,
    as the reference's default); b (N, B) lanes → :func:`gauss_solve_lanes`."""
    if b.ndim == 1:
        return gauss_solve(A, b)
    return gauss_solve_lanes(A, b)
