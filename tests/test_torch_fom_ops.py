"""The port's banded FEM ops against the JAX package's, on the CPU in
float64 (romtime_tpu_torch/ops/assembly.py, ops/linalg.py, ops/mesh.py).

Anchors: tests/test_ops_assembly.py (the golden P1 operators, local ≡
global at degrees 1–5, point evaluation on the nodes, the norms, the
solves), tests/test_higher_degree.py (block PCR against dense at 1e-10)
and tests/test_dirichlet_topology.py (every Dirichlet layout detected
from the topology, local ≡ global under each). Every case feeds the same
seeded numpy inputs to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_almost_equal

from romtime_tpu.ops import assembly as ref_asm
from romtime_tpu.ops import linalg as ref_la
from romtime_tpu.ops.mesh import Mesh1D as RefMesh
from romtime_tpu_torch.ops import assembly as asm
from romtime_tpu_torch.ops import linalg as la
from romtime_tpu_torch.ops.mesh import Mesh1D

jax.config.update("jax_enable_x64", True)

DEGREES = [1, 2, 3, 4, 5]
F64 = torch.float64
FORMS = {
    "mass": (0, 0, lambda x, m: m.ones_like(x)),
    "stiffness": (1, 1, lambda x, m: 0.7 + m.sin(x)),
    "convection": (1, 0, lambda x, m: -(1.0 + 0.3 * x)),
}


def _meshes(L0, nx, degree):
    return Mesh1D(L0=L0, nx=nx, degree=degree), RefMesh(L0=L0, nx=nx,
                                                         degree=degree)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _ones(mesh, value=1.0):
    return value * torch.ones(mesh.xq_ref.shape, dtype=F64)


# ---------------------------------------------------------------------------
# Golden P1 operators (tests/test_ops_assembly.py:45-106)
# ---------------------------------------------------------------------------
def test_golden_mass_matrix():
    mesh = Mesh1D(L0=2.0, nx=3, degree=1)
    M = asm.apply_dirichlet_band(
        asm.assemble_bilinear_band(mesh, _ones(mesh), 0, 0, mesh.h0),
        (0, mesh.nh - 1), 1)
    expected = np.array(
        [1.0, 0.0, 0.0, 0.0,
         0.11111111, 0.44444444, 0.11111111, 0.0,
         0.0, 0.11111111, 0.44444444, 0.11111111,
         0.0, 0.0, 0.0, 1.0])
    assert_array_almost_equal(asm.band_to_dense(M, 1).numpy().flatten(),
                              expected)


def test_golden_stiffness_matrix():
    mesh = Mesh1D(L0=2.0, nx=3, degree=1)
    A = asm.apply_dirichlet_band(
        asm.assemble_bilinear_band(mesh, _ones(mesh, 1.10213887), 1, 1,
                                   mesh.h0), (0, mesh.nh - 1), 1)
    dense = asm.band_to_dense(A, 1).numpy()
    assert_array_almost_equal(
        dense[1], np.array([-1.65320831, 3.30641662, -1.65320831, 0.0]),
        decimal=6)
    assert_array_almost_equal(dense[0], np.array([1.0, 0.0, 0.0, 0.0]))


def test_golden_scaled_stiffness():
    mesh = Mesh1D(L0=1.0, nx=5, degree=1)

    def assemble(t, omega, alpha_0):
        scale = 1.0 + np.sin(omega * t)
        alpha = alpha_0 * (1.0 + t * t)
        A = asm.assemble_bilinear_band(mesh, _ones(mesh, alpha), 1, 1,
                                       mesh.h0 * scale)
        A = asm.apply_dirichlet_band(A, (0, mesh.nh - 1), 1)
        return asm.band_nonzero_entries(A, mesh)[2]

    omega = np.pi / 2.0 / 10.0
    expected0 = np.array([1.0, -2.5, 5.0, -2.5, -2.5, 5.0, -2.5,
                          -2.5, 5.0, -2.5, -2.5, 5.0, -2.5, 1.0])
    expected1 = np.array(
        [1.0, -38.07611845, 76.15223689, -38.07611845,
         -38.07611845, 76.15223689, -38.07611845, -38.07611845,
         76.15223689, -38.07611845, -38.07611845, 76.15223689,
         -38.07611845, 1.0])
    assert_allclose(assemble(0.0, omega, 0.5), expected0, atol=1e-12)
    assert_allclose(assemble(5.0, omega, 0.5), expected1, atol=1e-7)
    assert_allclose(assemble(0.0, omega, 0.5), expected0, atol=1e-12)


# ---------------------------------------------------------------------------
# Band and entry assembly against the reference, degrees 1–5
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("degree", DEGREES)
@pytest.mark.parametrize("form", list(FORMS))
def test_band_and_local_match_reference(degree, form):
    """The port's band equals the reference's (1e-13), and its gathered
    entries at every stored nonzero equal its band (local ≡ global,
    tests/test_ops_assembly.py:121-136)."""
    a, b, cfun = FORMS[form]
    mesh, rmesh = _meshes(1.0, 20, degree)
    xq = mesh.xq_ref
    c = cfun(_t(xq), torch)
    dirichlet = (0, mesh.nh - 1)

    A = asm.apply_dirichlet_band(
        asm.assemble_bilinear_band(mesh, c, a, b, mesh.h0), dirichlet, degree)
    A_ref = ref_asm.apply_dirichlet_band(
        ref_asm.assemble_bilinear_band(rmesh, cfun(jnp.asarray(xq), jnp),
                                       a, b, rmesh.h0), dirichlet, degree)
    assert_allclose(A.numpy(), np.asarray(A_ref), rtol=1e-13,
                    atol=1e-13 * np.abs(np.asarray(A_ref)).max())

    rows, cols, expected = asm.band_nonzero_entries(A, mesh)
    r_rows, r_cols, _ = ref_asm.band_nonzero_entries(A_ref, rmesh)
    assert np.array_equal(rows, r_rows) and np.array_equal(cols, r_cols)
    emap = mesh.build_entry_map(list(zip(rows, cols)),
                                dirichlet_dofs=dirichlet)
    check = asm.apply_entry_dirichlet(asm.assemble_bilinear_entries(
        mesh, emap, c[emap.elements], a, b, mesh.h0), emap)
    assert_allclose(expected, check.numpy())


@pytest.mark.parametrize("degree", DEGREES)
def test_vector_and_local_match_reference(degree):
    mesh, rmesh = _meshes(1.0, 20, degree)
    xq = mesh.xq_ref
    c = np.exp(-xq) * (1.0 + xq ** 2)
    dirichlet = (0, mesh.nh - 1)
    fh = asm.apply_dirichlet_vector(
        asm.assemble_linear_vector(mesh, _t(c), 0, mesh.h0), dirichlet)
    fh_ref = ref_asm.apply_dirichlet_vector(
        ref_asm.assemble_linear_vector(rmesh, jnp.asarray(c), 0, rmesh.h0),
        dirichlet)
    assert_allclose(fh.numpy(), np.asarray(fh_ref), rtol=1e-13, atol=1e-16)
    emap = mesh.build_entry_map([(d,) for d in range(mesh.nh)],
                                dirichlet_dofs=dirichlet)
    check = asm.apply_entry_dirichlet(asm.assemble_linear_entries(
        mesh, emap, _t(c)[emap.elements], 0, mesh.h0), emap)
    assert_allclose(fh.numpy(), check.numpy())


@pytest.mark.parametrize("degree", DEGREES)
def test_local_dofs_subset(degree):
    """A sparse dof subset (tests/test_ops_assembly.py:156-171)."""
    mesh = Mesh1D(L0=1.0, nx=100, degree=degree)
    c = _t(np.cos(3.0 * mesh.xq_ref))
    dirichlet = (0, mesh.nh - 1)
    fh = asm.apply_dirichlet_vector(
        asm.assemble_linear_vector(mesh, c, 0, mesh.h0), dirichlet).numpy()
    target = [5, 47, 98, 55, 14]
    emap = mesh.build_entry_map([(d,) for d in target],
                                dirichlet_dofs=dirichlet)
    check = asm.apply_entry_dirichlet(asm.assemble_linear_entries(
        mesh, emap, c[emap.elements], 0, mesh.h0), emap)
    assert_allclose(fh[target], check.numpy())


@pytest.mark.parametrize("degree", [1, 3])
def test_batched_band_is_each_lane(degree):
    """A trailing batch (coefficients (ne, Q, B), h (B,)) assembles each
    lane as its own scalar assembly (to the einsum's summation order)."""
    mesh = Mesh1D(L0=1.0, nx=12, degree=degree)
    rng = np.random.default_rng(degree)
    c = _t(rng.normal(size=mesh.xq_ref.shape + (3,)))
    h = mesh.h0 * _t(rng.uniform(0.8, 1.2, size=3))
    band = asm.assemble_bilinear_band(mesh, c, 1, 0, h)
    vec = asm.assemble_linear_vector(mesh, c, 1, h)
    for j in range(3):
        assert_allclose(band[..., j].numpy(), asm.assemble_bilinear_band(
            mesh, c[..., j], 1, 0, h[j]).numpy(), rtol=1e-14, atol=1e-15)
        assert_allclose(vec[..., j].numpy(), asm.assemble_linear_vector(
            mesh, c[..., j], 1, h[j]).numpy(), rtol=1e-14, atol=1e-15)


# ---------------------------------------------------------------------------
# Band algebra
# ---------------------------------------------------------------------------
def _random_band(p, nh, seed, batch=()):
    rng = np.random.RandomState(seed)
    band = rng.rand(*batch, 2 * p + 1, nh) * 0.1
    band[..., p, :] = 3.0 + rng.rand(*batch, nh)
    for j in range(2 * p + 1):
        for r in range(nh):
            if not 0 <= r + j - p < nh:
                band[..., j, r] = 0.0
    return band


@pytest.mark.parametrize("p", [1, 2, 3])
def test_band_algebra_matches_reference(p):
    """band_matvec, band_matmat, band_to_dense, band_gather_nnz and
    nnz_to_band against the reference's."""
    mesh, rmesh = _meshes(1.0, 10, p)
    band = _random_band(p, mesh.nh, seed=p)
    rng = np.random.default_rng(p)
    v = rng.normal(size=mesh.nh)
    V = rng.normal(size=(mesh.nh, 4))
    assert_allclose(asm.band_matvec(_t(band), _t(v), p).numpy(),
                    np.asarray(ref_asm.band_matvec(jnp.asarray(band),
                                                   jnp.asarray(v), p)),
                    rtol=1e-14, atol=1e-15)
    dense = asm.band_to_dense(_t(band), p).numpy()
    assert_allclose(dense, np.asarray(ref_asm.band_to_dense(
        jnp.asarray(band), p)), rtol=0, atol=0)
    assert_allclose(asm.band_matmat(_t(band), _t(V), p).numpy(), dense @ V,
                    atol=1e-12)
    rows, cols = mesh.band_pattern
    assert np.array_equal(rows, rmesh.band_pattern[0])
    assert np.array_equal(cols, rmesh.band_pattern[1])
    nnz = asm.band_gather_nnz(_t(band), rows, cols, p)
    assert_allclose(nnz.numpy(), np.asarray(ref_asm.band_gather_nnz(
        jnp.asarray(band), rows, cols, p)), rtol=0, atol=0)
    back = asm.nnz_to_band(nnz, rows, cols, p, mesh.nh)
    assert torch.equal(asm.band_gather_nnz(back, rows, cols, p), nnz)
    assert_allclose(back.numpy(), np.asarray(ref_asm.nnz_to_band(
        jnp.asarray(nnz.numpy()), rows, cols, p, mesh.nh)), rtol=0, atol=0)
    # A trailing batch: each lane's product.
    vb = _t(rng.normal(size=(mesh.nh, 2)))
    bb = torch.stack([_t(band), 2.0 * _t(band)], dim=-1)
    got = asm.band_matvec(bb, vb, p)
    for j in range(2):
        assert torch.equal(got[:, j], asm.band_matvec(bb[..., j], vb[:, j],
                                                      p))


def test_mesh_connectivity_matches_reference():
    mesh, rmesh = _meshes(1.0, 7, 3)
    assert mesh.p == rmesh.p == 3
    for a, b in zip(mesh.scatter_rows, rmesh.scatter_rows):
        assert np.array_equal(a, b)
    assert all(mesh.cell_dofs(e) == rmesh.cell_dofs(e) for e in range(7))


# ---------------------------------------------------------------------------
# Interpolation, point evaluation, norms
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("degree", DEGREES)
def test_interpolation_roundtrip_and_in_time(degree):
    """tests/test_ops_assembly.py:179-200."""
    mesh = Mesh1D(L0=1.0, nx=100, degree=degree)
    f = lambda x: x
    fh = asm.interpolate_dofs(f, mesh, scale=1.0)
    fhm = asm.interpolate_dofs(f, mesh, scale=0.33)
    assert np.isclose(float(torch.max(fhm)), 0.33)
    assert np.isclose(torch.linalg.norm(
        fh - asm.interpolate_dofs(f, mesh, scale=1.0)).item(), 0.0)
    omega = np.pi / 2.0 / 10.0
    for t in np.linspace(0.0, 10.0, 4):
        Lt = 1.0 + np.sin(omega * t)
        assert np.isclose(float(torch.max(asm.interpolate_dofs(
            f, mesh, scale=Lt))), Lt)


@pytest.mark.parametrize("degree", DEGREES)
def test_point_eval_and_norms_match_reference(degree):
    """Point evaluation (inside cells and exactly on nodes, ξ = 0), L2
    and H1 norms against the reference on a seeded FE function."""
    mesh, rmesh = _meshes(2.0, 16, degree)
    u = np.random.default_rng(degree).normal(size=mesh.nh)
    x = np.array([0.0, 0.3, 0.77, 0.5, 1.0, 1.999])
    got = asm.eval_function_at(_t(u), _t(x), mesh, scale=0.5).numpy()
    want = np.asarray(ref_asm.eval_function_at(jnp.asarray(u), jnp.asarray(x),
                                               rmesh, scale=0.5))
    assert np.isfinite(got).all()
    assert_allclose(got, want, rtol=1e-13, atol=1e-14)
    for port_norm, ref_norm in ((asm.norm_L2, ref_asm.norm_L2),
                                (asm.norm_H1, ref_asm.norm_H1)):
        assert_allclose(float(port_norm(_t(u), mesh, h_phys=0.07)),
                        float(ref_norm(jnp.asarray(u), rmesh, h_phys=0.07)),
                        rtol=1e-13)


def test_point_eval_and_norm():
    """tests/test_ops_assembly.py:250-256."""
    mesh = Mesh1D(L0=2.0, nx=64, degree=2)
    u = asm.interpolate_dofs(lambda x: x ** 2, mesh, scale=0.5).to(F64)
    v = asm.eval_function_at(u, _t([0.3, 0.77]), mesh, scale=0.5)
    assert_allclose(v.numpy(), [0.09, 0.5929], atol=1e-6)
    u64 = _t(np.asarray(mesh.x_dofs) * 0.5) ** 2
    v = asm.eval_function_at(u64, _t([0.3, 0.77]), mesh, scale=0.5)
    assert_allclose(v.numpy(), [0.09, 0.5929], atol=1e-13)
    n = asm.norm_L2(u64, mesh, h_phys=mesh.h0 * 0.5)
    assert np.isclose(float(n), np.sqrt(1.0 / 5.0), atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_point_eval_exactly_on_nodes(dtype):
    """tests/test_ops_assembly.py:259-269: probes on mesh nodes do not
    NaN, in either dtype (x=0.5 on h=0.001, the flagship probe, too)."""
    for nx in (400, 1000):
        mesh = Mesh1D(L0=1.0, nx=nx, degree=1)
        u = torch.sin(3.0 * torch.as_tensor(mesh.x_dofs, dtype=dtype))
        v = asm.eval_function_at(u, torch.tensor([0.0, 0.5, 1.0],
                                                 dtype=dtype), mesh)
        tol = 1e-12 if dtype == torch.float64 else 1e-6
        assert_allclose(v.numpy(), np.sin(3.0 * np.array([0.0, 0.5, 1.0])),
                        atol=tol)


# ---------------------------------------------------------------------------
# Solves
# ---------------------------------------------------------------------------
def _physics_band(nx, p, batch=0):
    mesh = Mesh1D(L0=1.0, nx=nx, degree=p)
    ones = _ones(mesh)
    K = asm.assemble_bilinear_band(mesh, ones, 0, 0, mesh.h0)
    K = K + 0.1 * asm.assemble_bilinear_band(mesh, ones, 1, 1, mesh.h0)
    return mesh, asm.apply_dirichlet_band(K, (0, mesh.nh - 1), p)


@pytest.mark.parametrize("method", ["thomas", "pcr"])
def test_tridiag_solves_match_reference(method):
    """Thomas and PCR against the reference's and a dense solve
    (tests/test_ops_assembly.py:206-234)."""
    mesh, K = _physics_band(50, 1)
    b = torch.sin(_t(mesh.x_dofs))
    fn, ref_fn = {"thomas": (la.tridiag_solve, ref_la.tridiag_solve),
                  "pcr": (la.tridiag_solve_pcr,
                          ref_la.tridiag_solve_pcr)}[method]
    x = fn(K, b)
    assert torch.abs(asm.band_matvec(K, x, 1) - b).max().item() < 1e-11
    assert_allclose(x.numpy(), np.linalg.solve(asm.band_to_dense(K, 1).numpy(),
                                               b.numpy()), atol=1e-10)
    assert_allclose(x.numpy(), np.asarray(ref_fn(jnp.asarray(K.numpy()),
                                                 jnp.asarray(b.numpy()))),
                    rtol=1e-12, atol=1e-14)
    # Leading batch axes broadcast: a (7, nh) right-hand side.
    B = _t(np.random.default_rng(0).normal(size=(7, mesh.nh)))
    X = fn(K.expand(7, *K.shape), B)
    X1 = fn(K, B)
    for i in range(7):
        assert_allclose(X[i].numpy(), fn(K, B[i]).numpy(), atol=1e-12)
    assert_allclose(X1.numpy(), X.numpy(), atol=0)


@pytest.mark.parametrize("p", [2, 3, 4, 5])
@pytest.mark.parametrize("nh", [17, 64])
def test_block_pcr_matches_dense(p, nh):
    """tests/test_higher_degree.py:23-41."""
    band = _random_band(p, nh, seed=p * 100 + nh)
    rhs = np.random.RandomState(p * 100 + nh).rand(nh)
    x_ref = np.linalg.solve(asm.band_to_dense(_t(band), p).numpy(), rhs)
    x = la.solve_banded_block_pcr(_t(band), _t(rhs), p).numpy()
    assert_allclose(x, x_ref, atol=1e-10)


def test_block_pcr_matches_reference():
    """The block PCR against the reference's on the same system (its
    eager JAX run costs seconds a case, so one case)."""
    p, nh = 2, 17
    band = _random_band(p, nh, seed=7)
    rhs = np.random.RandomState(7).rand(nh)
    assert_allclose(la.solve_banded_block_pcr(_t(band), _t(rhs), p).numpy(),
                    np.asarray(ref_la.solve_banded_block_pcr(
                        jnp.asarray(band), jnp.asarray(rhs), p)),
                    rtol=1e-12, atol=1e-14)


def test_block_pcr_batched():
    """tests/test_higher_degree.py:44-53."""
    p, nh, B = 3, 50, 4
    rng = np.random.RandomState(0)
    band = rng.rand(B, 2 * p + 1, nh) * 0.1
    band[:, p] = 3.0
    rhs = rng.rand(B, nh)
    xb = la.solve_banded(_t(band), _t(rhs), p).numpy()
    for i in range(B):
        dense = asm.band_to_dense(_t(band[i]), p).numpy()
        assert_allclose(xb[i], np.linalg.solve(dense, rhs[i]), atol=1e-10)


@pytest.mark.parametrize("degree", [2, 3, 5])
def test_banded_solve_higher_degree(degree):
    """tests/test_ops_assembly.py:237-247, with the dense branch."""
    mesh = Mesh1D(L0=1.0, nx=12, degree=degree)
    ones = _ones(mesh)
    K = asm.assemble_bilinear_band(mesh, ones, 0, 0, mesh.h0)
    K = K + 0.05 * asm.assemble_bilinear_band(mesh, ones, 1, 1, mesh.h0)
    K = asm.apply_dirichlet_band(K, (0, mesh.nh - 1), degree)
    b = torch.cos(_t(mesh.x_dofs))
    for method in (None, "dense"):
        x = la.solve_banded(K, b, degree, method=method)
        assert torch.abs(asm.band_matvec(K, x, degree) - b).max() < 1e-10


def test_block_tridiag_from_band_matches_reference():
    band = _random_band(3, 20, seed=3)
    got = la.block_tridiag_from_band(_t(band), 3)
    want = ref_la.block_tridiag_from_band(jnp.asarray(band), 3)
    for g, w in zip(got[:3], want[:3]):
        assert_allclose(g.numpy(), np.asarray(w), atol=0)
    assert got[3:] == tuple(want[3:])
    rng = np.random.default_rng(3)
    A = rng.normal(size=(4, 5, 5)) + 6 * np.eye(5)
    b = rng.normal(size=(4, 5))
    assert_allclose(la.solve_dense_batch(_t(A), _t(b)).numpy(),
                    np.asarray(ref_la.solve_dense_batch(jnp.asarray(A),
                                                        jnp.asarray(b))),
                    rtol=1e-12)


# ---------------------------------------------------------------------------
# Dirichlet layouts detected from the topology
# (tests/test_dirichlet_topology.py)
# ---------------------------------------------------------------------------
LAYOUTS = {"left": {"b0": 0.0, "db0_dt": 0.0},
           "right": {"bL": 0.0, "dbL_dt": 0.0},
           "both": None}


def _burgers_pair(dirichlet, nx=60):
    from romtime_tpu.fom.nonlinear import OneDimensionalBurgers as RefBurgers
    from romtime_tpu.problems import define_piston_problem as ref_problem
    from romtime_tpu_torch.fom import OneDimensionalBurgers
    from romtime_tpu_torch.problems import define_piston_problem

    d, _bcs, _f, u0, Lt, dLt = define_piston_problem(L=1.0, nx=nx, tf=5.0,
                                                     nt=100)
    port = OneDimensionalBurgers(domain=d, dirichlet=dirichlet, u0=u0, Lt=Lt,
                                 dLt_dt=dLt, device="cpu")
    port.setup()
    d, _bcs, _f, u0, Lt, dLt = ref_problem(L=1.0, nx=nx, tf=5.0, nt=100)
    ref = RefBurgers(domain=d, dirichlet=dirichlet, u0=u0, Lt=Lt, dLt_dt=dLt)
    ref.setup()
    return port, ref


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_dirichlet_layout_detected(layout):
    port, ref = _burgers_pair(LAYOUTS[layout])
    nh = port.mesh.nh
    assert port.dirichlet_dofs == ref.dirichlet_dofs == {
        "left": (0,), "right": (nh - 1,), "both": (0, nh - 1)}[layout]
    assert port.entries_dirichlet == ref.entries_dirichlet
    assert port.dofs_dirichlet == ref.dofs_dirichlet


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_local_equals_global_every_layout(layout):
    """Gathered entries ≡ the port's band ≡ the reference's band, at
    boundary and interior entries (tests/test_dirichlet_topology.py:80-101)."""
    port, ref = _burgers_pair(LAYOUTS[layout])
    nh = port.mesh.nh
    mu = dict(a0=9.3, omega=17.5, delta=0.12, alpha=1e-6, gamma=1.4)
    mu_t = {k: torch.tensor(v, dtype=F64) for k, v in mu.items()}
    mu_j = {k: jnp.asarray(v) for k, v in mu.items()}
    t = torch.tensor(0.7, dtype=F64)
    entries = [(0, 0), (0, 1), (5, 6), (nh // 2, nh // 2),
               (nh - 1, nh - 2), (nh - 1, nh - 1)]
    for name in ("assemble_stiffness", "assemble_convection",
                 "assemble_mass"):
        dense = getattr(port, name)(mu=mu_t, t=t).todense()
        want = getattr(ref, name)(mu=mu_j, t=jnp.asarray(0.7)).todense()
        assert_allclose(dense, want, rtol=1e-13, atol=1e-12)
        local = getattr(port, name)(mu=mu_t, t=t, entries=entries).numpy()
        assert_allclose(local, np.array([dense[r, c] for r, c in entries]),
                        atol=1e-14)
