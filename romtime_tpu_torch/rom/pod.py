"""POD orthogonalization (counterpart of ``romtime_tpu/rom/pod.py``).

The SVD runs on the host CPU, as the reference runs its float64 SVD
there (``pod.py:23-31``): the snapshots go to the host once, as a numpy
array (a tensor on the card is copied over), and ``torch.linalg.svd``
factors them in their own dtype, float64 for every offline build of the
port. The truncation is host-side numpy: the retained rank depends on
the data.

A stated departure from the reference: an SVD that returns a non-finite
singular value raises ``FloatingPointError``. The reference's jax CPU
SVD can return NaN σ for a rank-1 float64 matrix under threaded OpenBLAS
and then keeps 0 modes without a word, which leaves an MDEIM with no
interpolation dofs; ``orth`` never keeps 0 modes in silence.
"""

import numpy as np
import torch

DROP_TOLERANCE = 1e-7


def _host_svd(a):
    """(u, s, vt) of the (m, n) array ``a`` by ``torch.linalg.svd`` on
    the CPU in ``a``'s dtype, as numpy."""
    u, s, vt = torch.linalg.svd(torch.from_numpy(np.ascontiguousarray(a)),
                                full_matrices=False)
    return u.numpy(), s.numpy(), vt.numpy()


def orth(snapshots, num=None, tol=None, normalize=True, return_VT=False):
    """An orthonormal basis of the snapshot span by SVD (reference
    ``pod.py:34-91``).

    Truncation modes:
    - ``tol``: keep the modes whose cumulative energy is *below* tol;
    - ``num``: keep the first ``num`` modes;
    - neither: drop the modes with σ under max(1e-7, 50·eps·σ₁), the
      dtype-aware floor (1e-7 in float64 but for huge σ₁).

    ``normalize`` scales every snapshot column to unit norm first.
    Returns numpy (Q, sigmas, energy[, VT]).
    """
    if isinstance(snapshots, list):
        raise ValueError("You should use an array, not a list.")
    if torch.is_tensor(snapshots):
        snapshots = snapshots.detach().cpu().numpy()
    snapshots = np.asarray(snapshots)

    if normalize:
        _snapshots = np.divide(snapshots, np.linalg.norm(snapshots, axis=0))
    else:
        _snapshots = snapshots

    u, s, vt = _host_svd(_snapshots)
    keep, energy = truncation(s, tol, num, _snapshots.dtype)
    Q = u[:, keep]
    if return_VT:
        return Q, s, energy, vt[keep, :]
    return Q, s, energy


def truncation(s, tol=None, num=None, dtype=np.float64):
    """(keep, energy) of the singular values ``s`` by :func:`orth`'s
    rules: ``keep`` indexes the retained modes, ``energy`` is the
    cumulative energy. Raises ``FloatingPointError`` on a non-finite
    singular value."""
    if not np.isfinite(s).all():
        raise FloatingPointError(
            f"the SVD of a {np.dtype(dtype)} snapshot matrix returned "
            f"non-finite singular values; refusing to truncate on them")
    eigenvalues = np.power(s, 2)
    energy = np.cumsum(eigenvalues) / np.sum(eigenvalues)
    if tol:
        return energy < tol, energy
    if num:
        return slice(0, num), energy
    eps = np.finfo(dtype).eps
    threshold = max(DROP_TOLERANCE, 50.0 * eps * (s[0] if s.size else 0.0))
    return s > threshold, energy
