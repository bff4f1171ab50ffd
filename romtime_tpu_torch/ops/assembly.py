"""Weak-form assembly on banded storage and at DEIM entries (counterpart
of ``romtime_tpu/ops/assembly.py``).

Every operator is A_ij = Σ_e ∫_e c(x, t, μ)·u^(a)·v^(b) dx; on a uniform
mesh scaled by the ALE factor s (h = s·h0) the element integral pulls
back to the reference element:

    local[e, i, j, ...] = h^(1-a-b) · Σ_q w_q · c[e, q, ...] · P_j^(a)(ξ_q) · P_i^(b)(ξ_q)

Coefficient arrays carry any trailing batch shape ``...`` (μ lanes, or
time × μ lanes in the serving prep), so one call assembles a whole batch.
Banded storage: band[d, r, ...] = A[r, r + d - p, ...], d ∈ [0, 2p]; the
batch trails there too. The banded solves (:mod:`.linalg`) take leading
batch axes, as the reference's do.
"""

import numpy as np
import torch


def _table(arr, like):
    return torch.as_tensor(np.asarray(arr), dtype=like.dtype,
                           device=like.device)


def _trailing(t, ndim):
    """``t`` with singleton axes appended up to ``ndim`` axes."""
    return t.reshape(t.shape + (1,) * (ndim - t.ndim))


# ----------------------------------------------------------------------
# Local element integration
# ----------------------------------------------------------------------
def _form_table(mesh, like, b, a=None):
    """The quadrature table of a weak form, (K, Q) in ``like``'s dtype on
    its device, cached on the mesh: w_q·P_j^(a)(ξ_q)·P_i^(b)(ξ_q) at row
    K = i·(p+1) + j (bilinear; i test, j trial), or w_q·P_i^(b)(ξ_q) at
    row i (linear, ``a=None``). Folding the weights and basis values into
    one table makes each element integral one matrix product."""
    tab = mesh.on(like.dtype, like.device)
    got = tab.forms.get((a, b))
    if got is None:
        t = mesh.tables
        test = t.basis_table(b) * t.quad_weights[:, None]        # (Q, p+1)
        if a is None:
            table = test.T
        else:
            trial = t.basis_table(a)
            table = np.einsum("qi,qj->ijq", test, trial).reshape(
                -1, len(t.quad_weights))
        got = _table(table, like)
        tab.forms[(a, b)] = got
    return got


def _integrate(c_eq, table, n_local):
    """Σ_q table[k, q]·c[e, q, ...] → (ne, *n_local, ...) by one batched
    product over the flattened batch."""
    ne, Q = c_eq.shape[:2]
    batch = tuple(c_eq.shape[2:])
    out = torch.matmul(table, c_eq.reshape(ne, Q, -1))
    return out.reshape((ne,) + n_local + batch)


def _local_bilinear(c_eq, mesh, a, b, h_phys, folded=False):
    """local[e, i, j, ...] with i = test (row), j = trial (col). The
    entry path contracts by einsum, the rounding its served parity limits
    were measured with; ``folded`` (the band assembly, every step of the
    FOM's time loop) takes the folded table, one matmul and a third of
    the einsum's dispatches."""
    if folded:
        p1 = mesh.degree + 1
        local = _integrate(c_eq, _form_table(mesh, c_eq, b, a), (p1, p1))
    else:
        tab = mesh.on(c_eq.dtype, c_eq.device)
        local = torch.einsum("eq...,q,qj,qi->eij...", c_eq, tab.w,
                             tab.B1 if a else tab.B0,
                             tab.B1 if b else tab.B0)
    return local * h_phys ** (1 - a - b)


def _local_linear(c_eq, mesh, b, h_phys, folded=False):
    """local[e, i, ...] with i = test (row); ``folded`` as above."""
    if folded:
        local = _integrate(c_eq, _form_table(mesh, c_eq, b),
                           (mesh.degree + 1,))
    else:
        tab = mesh.on(c_eq.dtype, c_eq.device)
        local = torch.einsum("eq...,q,qi->ei...", c_eq, tab.w,
                             tab.B1 if b else tab.B0)
    return local * h_phys ** (1 - b)


# ----------------------------------------------------------------------
# Global assembly (banded)
# ----------------------------------------------------------------------
def _strided(i, mesh):
    """Global rows of local index ``i`` over all cells: a strided slice."""
    p = mesh.degree
    return slice(i, i + p * (mesh.ne - 1) + 1, p)


def scatter_band(local, mesh):
    """Element matrices (ne, p+1, p+1, ...) into the banded global matrix
    (2p+1, nh, ...), accumulated in the reference's (i, j) order."""
    p = mesh.degree
    band = local.new_zeros((2 * p + 1, mesh.nh) + tuple(local.shape[3:]))
    for i in range(p + 1):
        for j in range(p + 1):
            band[j - i + p, _strided(i, mesh)].add_(local[:, i, j])
    return band


def scatter_vector(local, mesh):
    """Element vectors (ne, p+1, ...) into the global vector (nh, ...)."""
    p = mesh.degree
    vec = local.new_zeros((mesh.nh,) + tuple(local.shape[2:]))
    for i in range(p + 1):
        vec[_strided(i, mesh)].add_(local[:, i])
    return vec


def assemble_bilinear_band(mesh, c_eq, a, b, h_phys):
    """A bilinear form as a banded matrix; ``c_eq`` (ne, Q, ...) holds the
    coefficient at the physical quadrature points, ``h_phys`` the
    physical cell width (a scalar or the batch's shape)."""
    return scatter_band(_local_bilinear(c_eq, mesh, a, b, h_phys,
                                        folded=True), mesh)


def assemble_linear_vector(mesh, c_eq, b, h_phys):
    """A linear form as a global vector (nh, ...)."""
    return scatter_vector(_local_linear(c_eq, mesh, b, h_phys, folded=True),
                          mesh)


# ----------------------------------------------------------------------
# Gathered assembly at DEIM entries
# ----------------------------------------------------------------------
def assemble_bilinear_entries(mesh, entry_map, c_eq_needed, a, b, h_phys):
    """Integrate a bilinear form at the map's matrix entries only;
    ``c_eq_needed`` holds coefficients at the quadrature points of
    ``entry_map.elements``. The Dirichlet override is left to the caller
    (:func:`apply_entry_dirichlet`, once per sum of terms)."""
    return _gather_terms(_local_bilinear(c_eq_needed, mesh, a, b, h_phys),
                         entry_map, is_vector=False)


def assemble_linear_entries(mesh, entry_map, c_eq_needed, b, h_phys):
    """Integrate a linear form at the map's dofs only (no Dirichlet
    override, as above)."""
    return _gather_terms(_local_linear(c_eq_needed, mesh, b, h_phys),
                         entry_map, is_vector=True)


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


# ----------------------------------------------------------------------
# Dirichlet conditions (row elimination; columns untouched)
# ----------------------------------------------------------------------
def apply_dirichlet_band(band, dirichlet_dofs, p, entry=1.0):
    """bc.apply for matrices: zero rows, unit diagonal (a new band)."""
    band = band.clone()
    for r in dirichlet_dofs:
        band.select(1, r).fill_(0.0)
        band[p].select(0, r).fill_(entry)
    return band


def apply_dirichlet_vector(vec, dirichlet_dofs, value=0.0):
    """bc.apply for vectors: pin entries to the Dirichlet value."""
    vec = vec.clone()
    for r in dirichlet_dofs:
        vec.select(0, r).fill_(value)
    return vec


# ----------------------------------------------------------------------
# Banded-matrix algebra
# ----------------------------------------------------------------------
def _pad_rows(v, p):
    """``v`` (nh, ...) with p zero rows above and below."""
    zeros = v.new_zeros((p,) + tuple(v.shape[1:]))
    return torch.cat([zeros, v, zeros])


def band_matvec(band, v, p):
    """y = A v with banded A (2p+1, nh, ...) and v (nh, ...): (2p+1)
    shifted elementwise products, summed in the reference's order."""
    nh = v.shape[0]
    vpad = _pad_rows(v, p)
    out = band[0] * vpad[0:nh]
    for d in range(1, 2 * p + 1):
        out = out + band[d] * vpad[d:d + nh]
    return out


def band_matmat(band, V, p):
    """Y = A V with banded A (2p+1, nh) and dense V (nh, k); O(p·nh·k)."""
    nh = V.shape[0]
    Vpad = _pad_rows(V, p)
    out = band[0][:, None] * Vpad[0:nh]
    for d in range(1, 2 * p + 1):
        out = out + band[d][:, None] * Vpad[d:d + nh]
    return out


def band_to_dense(band, p):
    """Densify a banded matrix (..., 2p+1, nh) → (..., nh, nh), leading
    batch axes kept (small problems, checks, the p > 5 solve)."""
    nh = band.shape[-1]
    dense = band.new_zeros(tuple(band.shape[:-2]) + (nh, nh))
    rows = torch.arange(nh, device=band.device)
    for d in range(2 * p + 1):
        cols = rows + d - p
        valid = (cols >= 0) & (cols < nh)
        dense[..., rows[valid], cols[valid]] = band[..., d, :][..., valid]
    return dense


def band_gather_nnz(band, rows, cols, p):
    """The structural-nonzero vector A[rows, cols] (nnz, ...) from banded
    storage; (rows, cols) lie inside the band."""
    rows = torch.as_tensor(rows, device=band.device)
    cols = torch.as_tensor(cols, device=band.device)
    return band[cols - rows + p, rows]


def band_nonzero_entries(band, mesh, tolerance=None):
    """Rows, cols and values (numpy) of the stored nonzeros of a banded
    operator, ``scipy.sparse.find`` on the reference's CSR: structural
    positions whose value is exactly zero are dropped; with
    ``tolerance``, values within it of zero count as zero. Host-side;
    fixes operator topologies once."""
    rows, cols = mesh.band_pattern
    values = band.detach().cpu().numpy()[cols - rows + mesh.degree, rows]
    if tolerance is not None:
        close = np.isclose(values, 0.0, rtol=tolerance, atol=tolerance)
        values = np.where(close, 0.0, values)
    keep = values != 0.0
    return rows[keep], cols[keep], values[keep]


def nnz_to_band(values, rows, cols, p, nh):
    """Scatter a nonzero vector (nnz, ...) back into banded storage."""
    band = values.new_zeros((2 * p + 1, nh) + tuple(values.shape[1:]))
    rows = torch.as_tensor(rows, device=values.device)
    cols = torch.as_tensor(cols, device=values.device)
    band[cols - rows + p, rows] = values
    return band


# ----------------------------------------------------------------------
# Function-space operations
# ----------------------------------------------------------------------
def _dofs_at(mesh, scale, dtype=None, device=None):
    """Dof coordinates scaled by ``scale`` (a number or a tensor, whose
    shape trails): (nh, *scale.shape)."""
    if torch.is_tensor(scale):
        x = mesh.on(scale.dtype, scale.device).x
        return x.reshape((-1,) + (1,) * scale.ndim) * scale
    return mesh.on(dtype, device or "cpu").x * scale


def interpolate_dofs(fn, mesh, scale=1.0, **kwargs):
    """Interpolate a callable onto the (scaled) dof grid: for Lagrange
    elements, evaluation at the dof coordinates (``fenics.interpolate``).
    A number ``scale`` evaluates in the compute dtype on the CPU."""
    from ..dtypes import compute_dtype

    return fn(_dofs_at(mesh, scale, compute_dtype()), **kwargs)


def eval_function_at(u, x_eval, mesh, scale=1.0):
    """The FE function with dof values ``u`` (nh, ...) at physical points
    ``x_eval`` (m,): the owning cell by floor(x/h) in the compute dtype,
    the Lagrange polynomials by their monomial coefficients at integer
    powers (a tensor exponent gives NaN at ξ = 0, on a node). ``scale``
    is a number or a 0-d tensor. (m, ...)."""
    p = mesh.degree
    tab = mesh.on(u.dtype, u.device)
    # h as a tensor on u's device (a fill, no host copy): CUDA divides by
    # a host scalar through its reciprocal, which can move a point on a
    # node (x=0.5, h=0.001) into the cell on its left.
    if torch.is_tensor(scale):
        h = mesh.h0 * scale
    else:
        h = torch.full((), mesh.h0 * scale, dtype=u.dtype, device=u.device)
    x_eval = torch.atleast_1d(torch.as_tensor(x_eval, dtype=u.dtype,
                                              device=u.device))
    e = torch.clamp(torch.floor(x_eval / h).to(torch.int64), 0, mesh.ne - 1)
    xi = x_eval / h - e
    powers = torch.stack([xi ** i for i in range(p + 1)], dim=1)  # (m, p+1)
    basis = powers @ tab.coeffs.T                                  # P_i(ξ)
    local_dofs = (e * p)[:, None] + torch.arange(p + 1, device=u.device)
    vals = u[local_dofs]                                  # (m, p+1, ...)
    return torch.sum(vals * _trailing(basis, vals.ndim), dim=1)


def norm_L2(u, mesh, h_phys=None):
    """(∫ u_h² dx)^½ over the (scaled) mesh by FE-exact quadrature
    (``fenics.errornorm``, degree_rise=0); ``u`` (nh, ...) → (...)."""
    if h_phys is None:
        h_phys = mesh.h0
    w = mesh.on(u.dtype, u.device).w
    u_eq = _function_at_quad(u, mesh)
    return torch.sqrt(h_phys * torch.sum(_trailing(w, u_eq.ndim - 1)
                                         * u_eq ** 2, dim=(0, 1)))


def norm_H1(u, mesh, h_phys=None):
    """The full H1 norm (∫ u² + ∫ (u′)²)^½."""
    if h_phys is None:
        h_phys = mesh.h0
    w = mesh.on(u.dtype, u.device).w
    u_eq = _function_at_quad(u, mesh, derivative=0)
    du_eq = _function_at_quad(u, mesh, derivative=1) / h_phys
    val = h_phys * torch.sum(_trailing(w, u_eq.ndim - 1)
                             * (u_eq ** 2 + du_eq ** 2), dim=(0, 1))
    return torch.sqrt(val)


def _function_at_quad(u, mesh, derivative=0):
    """The FE function (or its derivative, reference coordinates) at the
    quadrature points: (ne, Q, ...)."""
    tab = mesh.on(u.dtype, u.device)
    return _at_quad(_gather_cell_dofs(u, mesh),
                    tab.B1 if derivative else tab.B0)


def _at_quad(u_loc, table):
    """Element-local dof values (ne, p+1, ...) at the quadrature points
    through a basis table (Q, p+1): (ne, Q, ...)."""
    return _integrate(u_loc, table, (table.shape[0],))


def _gather_cell_dofs(u, mesh):
    """(ne, p+1, ...) element-local dof values by strided slices."""
    return torch.stack([u[_strided(i, mesh)] for i in range(mesh.degree + 1)],
                       dim=1)
