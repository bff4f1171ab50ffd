"""Small dense solves (counterpart of ``romtime_tpu/ops/linalg.py``):
the batch-last elimination of the windowed lanes engine."""

import torch


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
