"""Gathered weak-form assembly at DEIM entries (counterpart of the
entry path of ``romtime_tpu/ops/assembly.py``).

Every operator is A_ij = Σ_e ∫_e c(x, t, μ)·u^(a)·v^(b) dx; on a uniform
mesh scaled by the ALE factor s (h = s·h0) the element integral pulls
back to the reference element:

    local[e, i, j, ...] = h^(1-a-b) · Σ_q w_q · c[e, q, ...] · P_j^(a)(ξ_q) · P_i^(b)(ξ_q)

Coefficient arrays carry any trailing batch shape ``...`` (time × μ
lanes in the serving prep), so one call assembles a whole table. Only the
gathered-entry path exists here: serving never assembles a full band.
"""

import numpy as np
import torch


def _table(arr, like):
    return torch.as_tensor(np.asarray(arr), dtype=like.dtype,
                           device=like.device)


def _local_bilinear(c_eq, tables, a, b, h_phys):
    """local[e, i, j, ...] with i = test (row), j = trial (col)."""
    Dtrial = _table(tables.basis_table(a), c_eq)
    Dtest = _table(tables.basis_table(b), c_eq)
    w = _table(tables.quad_weights, c_eq)
    local = torch.einsum("eq...,q,qj,qi->eij...", c_eq, w, Dtrial, Dtest)
    return local * h_phys ** (1 - a - b)


def _local_linear(c_eq, tables, b, h_phys):
    """local[e, i, ...] with i = test (row)."""
    Dtest = _table(tables.basis_table(b), c_eq)
    w = _table(tables.quad_weights, c_eq)
    local = torch.einsum("eq...,q,qi->ei...", c_eq, w, Dtest)
    return local * h_phys ** (1 - b)


def assemble_bilinear_entries(mesh, entry_map, c_eq_needed, a, b, h_phys):
    """Integrate a bilinear form at the map's matrix entries only;
    ``c_eq_needed`` holds coefficients at the quadrature points of
    ``entry_map.elements``. The Dirichlet override is left to the caller
    (:func:`apply_entry_dirichlet`, once per sum of terms)."""
    return _gather_terms(
        _local_bilinear(c_eq_needed, mesh.tables, a, b, h_phys),
        entry_map, is_vector=False,
    )


def assemble_linear_entries(mesh, entry_map, c_eq_needed, b, h_phys):
    """Integrate a linear form at the map's dofs only (no Dirichlet
    override, as above)."""
    return _gather_terms(
        _local_linear(c_eq_needed, mesh.tables, b, h_phys),
        entry_map, is_vector=True,
    )


def apply_entry_dirichlet(values, entry_map):
    """Override Dirichlet-convention entries; ``values`` may carry
    trailing batch axes."""
    trailing = (1,) * (values.ndim - 1)
    mask = torch.as_tensor(entry_map.dirichlet_mask,
                           device=values.device).reshape((-1,) + trailing)
    diri = _table(entry_map.dirichlet_values, values).reshape(
        (-1,) + trailing)
    return torch.where(mask, diri, values)


def _gather_terms(local, entry_map, is_vector):
    """entries = W · vec(local) with the static 0/1 accumulation matrix W
    (one small dense product instead of a scatter)."""
    n_local = 2 if is_vector else 3
    batch = tuple(local.shape[n_local:])
    if len(entry_map.term_entry) == 0:
        return local.new_zeros((entry_map.n_entries,) + batch)
    local_shape = tuple(local.shape[:n_local])
    W = _entry_accumulation_matrix(entry_map, local_shape, is_vector)
    flat = local.reshape((int(np.prod(local_shape)), -1))
    return (_table(W, local) @ flat).reshape((entry_map.n_entries,) + batch)


def _entry_accumulation_matrix(entry_map, local_shape, is_vector):
    """Static (n_entries, prod(local_shape)) accumulation matrix, cached
    on the (frozen) entry map."""
    key = (local_shape, is_vector)
    cache = getattr(entry_map, "_accumulation_matrices", None)
    if cache is None:
        cache = {}
        object.__setattr__(entry_map, "_accumulation_matrices", cache)
    W = cache.get(key)
    if W is None:
        if is_vector:
            _, nb = local_shape
            flat = entry_map.term_elem_pos * nb + entry_map.term_i
        else:
            _, nb, _ = local_shape
            flat = (entry_map.term_elem_pos * nb * nb
                    + entry_map.term_i * nb + entry_map.term_j)
        W = np.zeros((entry_map.n_entries, int(np.prod(local_shape))))
        np.add.at(W, (entry_map.term_entry, flat), 1.0)
        cache[key] = W
    return W
