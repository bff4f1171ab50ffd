"""The port's global lanes engine (``engine="lanes"``,
romtime_tpu_torch/rom/engines/global_lanes.py), the reductors' PᵀU
θ-solve (romtime_tpu_torch/deim/deim.py) and ``gauss_solve``
(romtime_tpu_torch/ops/linalg.py) against the JAX package, on the
conftest piston cell (nx=150, nt=96) built by the JAX package
(tests/torch_parity.build_piston_hrom), its global basis truncated to
N=15 with the reference's ``truncate``.

The reference runs ``RomConstructor._online_scan_batch``
(romtime_tpu/rom/rom.py:681-829) through ``solve_batch(...,
engine="lanes")`` in x64. Limits: 1e-9·scale per output in float64 (all
three modes, both precompute branches) and 5e-6·scale in float32 (the
residual form with the dd carry, both branches); θ by the PᵀU solve
within 1e-12 relative of the reference's ``_thetas_traced`` in float64.
The port's own modes hold each other at the anchors
tests/test_rom.py:126 (reduced vs full) and :161 (probes vs reduced)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romtime_tpu.conventions import OperatorType, Stage
from romtime_tpu.dtypes import compute_dtype_scope
from romtime_tpu.ops.linalg import gauss_solve as ref_gauss_solve
from romtime_tpu.ops.linalg import solve_small as ref_solve_small
from romtime_tpu_torch import global_serving_from_arrays
from romtime_tpu_torch.dtypes import compute_dtype_scope as port_dtype_scope
from romtime_tpu_torch.ops.linalg import gauss_solve, solve_small
from romtime_tpu_torch.rom.engines import global_lanes
from torch_parity import (
    build_piston_hrom,
    global_payload_from_rom,
    piston_mus,
)

N_GLOBAL = 15
B = 5
REDUCTORS = ((OperatorType.MASS, "mdeim_Mh"),
             (OperatorType.STIFFNESS, "mdeim_Ah"),
             (OperatorType.RHS, "deim_rhs"),
             (OperatorType.CONVECTION, "mdeim_Ch"),
             (OperatorType.NONLINEAR_LIFTING, "mdeim_Nh_hat"),
             (OperatorType.TRILINEAR, "mdeim_Nh"))
DTYPES = {"float64": (jnp.float64, torch.float64, 1e-9),
          "float32": (jnp.float32, torch.float32, 5e-6)}
#: (dtype, mode, precompute branch) of the parity cases.
CASES = [("float64", "probes", "matrices"), ("float64", "reduced", "matrices"),
         ("float64", "full", "matrices"), ("float64", "reduced", "thetas"),
         ("float32", "reduced", "matrices"), ("float32", "reduced", "thetas")]


@pytest.fixture(scope="module")
def global_cell(tmp_path_factory):
    """(reference ROM at N=15, its payload, μ batch, port outputs per
    case, filled as the cases run)."""
    hrom = build_piston_hrom(tmp_path_factory.mktemp("torch_glanes"))
    full = hrom.rom
    rom = full.truncate(n=full.N - N_GLOBAL)
    for which, attr in REDUCTORS:
        rom.add_hyper_reductor(getattr(full, attr), which)
    rom.project_reductors()
    return rom, global_payload_from_rom(rom), piston_mus(B, seed=3), {}


def _reference(rom, mus, mode, jdtype, branch):
    cls = type(rom)
    saved = cls.ONLINE_PRECOMPUTE_BUDGET
    rom._online_fns = {}
    try:
        if branch == "thetas":
            cls.ONLINE_PRECOMPUTE_BUDGET = 0
        with compute_dtype_scope(jdtype):
            return rom.solve_batch(mus, step=Stage.ONLINE, mode=mode,
                                   engine="lanes")
    finally:
        cls.ONLINE_PRECOMPUTE_BUDGET = saved
        rom._online_fns = {}


def _port(payload, branch):
    port = global_serving_from_arrays(payload, device="cpu")
    if branch == "thetas":
        port.ONLINE_PRECOMPUTE_BUDGET = 0
    return port


@pytest.mark.parametrize("dtype,mode,branch", CASES)
def test_lanes_matches_reference(global_cell, monkeypatch, dtype, mode,
                                 branch):
    rom, payload, mus, seen = global_cell
    jdt, tdt, tol = DTYPES[dtype]
    want = _reference(rom, mus, mode, jdt, branch)
    taken = []
    real = global_lanes.lanes_branch
    monkeypatch.setattr(global_lanes, "lanes_branch",
                        lambda *a: taken.append(real(*a)) or taken[-1])
    port = _port(payload, branch)
    with port_dtype_scope(tdt):
        assert port._resolve_engine(mode, B) == "lanes"
        got = port.solve_batch(mus, mode=mode)
    assert taken == [branch]
    assert set(got) == set(want)
    for key in want:
        w = np.asarray(want[key])
        assert got[key].shape == w.shape, key
        assert got[key].dtype == w.dtype, key
        assert np.isfinite(got[key]).all(), key
        scale = max(np.abs(w).max(), 1e-30)
        err = np.abs(got[key] - w).max()
        print(f"{dtype} {mode} {branch} {key}: {err:.3e} (limit "
              f"{tol * scale:.3e})")
        assert err <= tol * scale, key
    seen[(dtype, mode, branch)] = got


def test_modes_agree(global_cell):
    """tests/test_rom.py:126 and :161 on the port (float64): reduced ≡
    full on uN (1e-12), the probes are the reconstructed end values
    (1e-10), and the probes mode is the reduced sweep (1e-14)."""
    _rom, payload, mus, seen = global_cell
    port = _port(payload, "matrices")
    with port_dtype_scope(torch.float64):
        out = {mode: seen.get(("float64", mode, "matrices"))
               or port.solve_batch(mus, mode=mode)
               for mode in ("probes", "reduced", "full")}
    full, red, served = out["full"], out["reduced"], out["probes"]
    np.testing.assert_allclose(red["uN"], full["uN"], atol=1e-12)
    assert "uc" not in red
    np.testing.assert_allclose(red["probes"][..., 0], full["uc"][..., 0],
                               atol=1e-10)
    np.testing.assert_allclose(red["probes"][..., 1], full["uc"][..., -1],
                               atol=1e-10)
    assert "uN" not in served and "uc" not in served
    np.testing.assert_allclose(served["probes"], red["probes"], atol=1e-14)
    np.testing.assert_allclose(served["uN_final"], red["uN"][:, -1, :],
                               atol=1e-14)


def test_thetas_by_pt_u_solve_match_reference(global_cell):
    """θ(μ, t) through the PᵀU solve in float64 against the reference's
    ``_thetas_traced`` (deim.py:428-437) at 1e-12 relative, on a μ batch;
    under float32 serving the raw entries (the folded form). And the
    reduced operators in each dtype's own form (``_combine_traced`` of θ)
    against the reference's ``_interpolate_traced``."""
    rom, payload, mus, _seen = global_cell
    port = _port(payload, "matrices")
    t = 0.37
    mu_j = {k: jnp.asarray([m[k] for m in mus]) for k in mus[0]}
    mu_t = {k: torch.tensor([m[k] for m in mus], dtype=torch.float64)
            for k in mus[0]}
    for name, red in port._theta_sources().items():
        ref_red = rom._theta_sources()[name][0]
        with compute_dtype_scope(jnp.float64):
            assert not ref_red._folded_serving()
            want = np.asarray(ref_red._thetas_traced(mu_j, jnp.asarray(t)))
            want_op = np.asarray(ref_red._interpolate_traced(
                mu_j, jnp.asarray(t), which=ref_red.ROM))
        with port_dtype_scope(torch.float64):
            assert not red._folded_serving()
            got = red._thetas_traced(mu_t, torch.tensor(
                t, dtype=torch.float64)).numpy()
            got_op = red._combine_traced(torch.as_tensor(got)).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-12 * np.abs(want).max(),
                                   err_msg=name)
        np.testing.assert_allclose(got_op, want_op, rtol=0,
                                   atol=1e-12 * np.abs(want_op).max(),
                                   err_msg=name)
        with port_dtype_scope(torch.float32):
            assert red._folded_serving()
            raw = red._thetas_traced(
                {k: v.float() for k, v in mu_t.items()},
                torch.tensor(t, dtype=torch.float32))
            np.testing.assert_array_equal(raw.numpy(), red._entries_traced(
                {k: v.float() for k, v in mu_t.items()},
                torch.tensor(t, dtype=torch.float32)).numpy())
            op32 = red._combine_traced(raw).numpy()
        np.testing.assert_allclose(op32, want_op, rtol=0,
                                   atol=1e-5 * np.abs(want_op).max(),
                                   err_msg=name)


@pytest.mark.parametrize("pivot", [True, False])
def test_gauss_solve_matches_reference(pivot):
    """ops/linalg.py ``gauss_solve`` (:296) on a batch of (N, N) systems
    and ``solve_small`` (:378) on (N,) and (N, B) right-hand sides, in
    float64, to 1e-13 relative."""
    rng = np.random.default_rng(5)
    N = 9
    A = rng.normal(size=(4, N, N))
    A[:, np.arange(N), np.arange(N)] += 3.0 if not pivot else 0.0
    b = rng.normal(size=(4, N))
    want = np.asarray(ref_gauss_solve(jnp.asarray(A), jnp.asarray(b),
                                      pivot=pivot))
    got = gauss_solve(torch.as_tensor(A), torch.as_tensor(b),
                      pivot=pivot).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)
    P = np.eye(N) + np.tril(0.3 * rng.normal(size=(N, N)), -1)
    for rhs in (rng.normal(size=N), rng.normal(size=(N, 7))):
        want = np.asarray(ref_solve_small(jnp.asarray(P), jnp.asarray(rhs)))
        got = solve_small(torch.as_tensor(P), torch.as_tensor(rhs)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)


def test_lanes_refusals(global_cell):
    """No trilinear table: a bare call resolves to the vmap engine, as
    the reference's does without its N-MDEIM (rom.py:1051-1060, the
    trilinear term projected from the FOM's assembly), and serves; the
    lanes engine asked for raises NotImplementedError naming the in-body
    N-MDEIM fallback's ROADMAP item; float64 without PᵀU: ValueError."""
    _rom, payload, mus, _seen = global_cell
    bare = _port({k: v for k, v in payload.items() if k != "trilinear"},
                 "matrices")
    assert bare._resolve_engine("reduced", 2) == "vmap"
    assert np.isfinite(bare.solve_batch(mus[:2], mode="reduced")["uN"]).all()
    with pytest.raises(NotImplementedError, match="N-MDEIM.*Queue 1"):
        bare.solve_batch(mus[:2], mode="reduced", engine="lanes")
    no_ptu = {k: v for k, v in payload.items() if not k.startswith("PT_U_")}
    port = _port(no_ptu, "matrices")
    with port_dtype_scope(torch.float64):
        with pytest.raises(ValueError, match="PT_U_"):
            port.solve_batch(mus[:2], mode="reduced")
    out = port.solve_batch(mus[:2], mode="reduced")
    assert np.isfinite(out["uN"]).all()
