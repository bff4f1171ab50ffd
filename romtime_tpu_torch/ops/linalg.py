"""Small dense solves (counterpart of ``romtime_tpu/ops/linalg.py``):
the unrolled Gauss-Jordan of the DEIM θ-systems and the batch-last
elimination of the lanes engines."""

import torch


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
    row_ids = torch.arange(N, device=b.device)
    for k in range(N):
        pivot_row = M[k] / M[k, k][None, :]           # (N+1, B)
        factor = M[:, k][:, None, :]                  # (N, 1, B)
        eliminated = M - factor * pivot_row[None, :, :]
        is_k = (row_ids == k)[:, None, None]
        M = torch.where(is_k, pivot_row[None], eliminated)
    return M[:, N, :]


def solve_small(A, b):
    """Shape-dispatching small dense solve of the DEIM θ-systems
    (reference ``linalg.py:378``): b (N,) → :func:`gauss_solve` (pivoted,
    as the reference's default); b (N, B) lanes → :func:`gauss_solve_lanes`."""
    if b.ndim == 1:
        return gauss_solve(A, b)
    return gauss_solve_lanes(A, b)
