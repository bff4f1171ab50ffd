"""POD by tall-skinny QR over the μ mesh (counterpart of
``romtime_tpu/parallel/tsqr.py``).

    S (Nh, M), its M columns split over the mesh's shards.
    A = Sᵀ is tall-skinny (M, Nh):
      per shard:   A_i = Q_i R_i                 (on the shard's device)
      gather:      R = QR(stack of the R_i)      (on the mesh's first device)
      small SVD:   R = U_R Σ V_Rᵀ
    ⇒ the left singular vectors of S are V_R, its singular values Σ.

The condition number is not squared (unlike the method of snapshots) and
only the R factors move between devices. The gather onto the first
device stands for the reference's ``all_gather`` of the R factors.
"""

import numpy as np
import torch

from ..rom.pod import truncation
from .mesh import device_mesh, mu_sharding


def tsqr_svd(snapshots, mesh=None):
    """Left singular vectors and singular values of the (Nh, M)
    ``snapshots`` (numpy, in its own dtype), as numpy (U (Nh, r), s (r,))
    with r = min(Nh, M padded). The columns are padded with zero columns
    to a multiple of ``mesh.size`` (default :func:`device_mesh`), so
    every shard's R has the same shape; zero columns leave the SVD as it
    is. U is unique up to column signs."""
    if mesh is None:
        mesh = device_mesh()
    snapshots = np.asarray(snapshots)
    nh, m = snapshots.shape
    pad = (-m) % mesh.size
    if pad:
        snapshots = np.concatenate(
            [snapshots, np.zeros((nh, pad), snapshots.dtype)], axis=1)
    A = torch.from_numpy(np.ascontiguousarray(snapshots.T))   # (M, Nh)
    home = mesh.devices[0]
    rs = [torch.linalg.qr(A[sl].to(dev), mode="r")[1]
          for dev, sl in mu_sharding(mesh, A.shape[0])]
    R = torch.linalg.qr(torch.cat([r.to(home) for r in rs]), mode="r")[1]
    _, s, vt = torch.linalg.svd(R, full_matrices=False)
    return vt.T.cpu().numpy(), s.cpu().numpy()


def orth_distributed(snapshots, num=None, tol=None, normalize=True,
                     mesh=None):
    """``rom.pod.orth`` on the TSQR backend, in float64 throughout:
    ``normalize`` scales each column to unit norm, then the truncation
    rules of ``orth`` (``tol`` on the cumulative energy, ``num`` modes,
    else the drop floor). Returns numpy (Q, sigmas, energy)."""
    snapshots = np.asarray(snapshots, np.float64)
    if normalize:
        snapshots = snapshots / np.linalg.norm(snapshots, axis=0)
    U, s = tsqr_svd(snapshots, mesh=mesh)
    keep, energy = truncation(s, tol, num, snapshots.dtype)
    return U[:, keep], s, energy
