"""Parity of the port's double-word f32 primitives
(romtime_tpu_torch/ops/compensated.py) with the JAX reference
(romtime_tpu/ops/compensated.py), mirroring tests/test_compensated.py.

Each op is a fixed sequence of individually rounded IEEE f32 ops in both
packages, so TwoSum, TwoProduct and the dd updates agree bit for bit;
the dd matvec is held to the reference test's 1e-13 relative bound."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import romtime_tpu.ops.compensated as ref
import romtime_tpu_torch.ops.compensated as port


def _pair(x):
    x = np.asarray(x, np.float32)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _dd_inputs(seed):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=64)
    u1 = u + 1e-3 * rng.normal(size=64)
    u_hi = np.float32(u)
    u1_hi = np.float32(u1)
    return [u_hi, np.float32(u - u_hi.astype(np.float64)),
            u1_hi, np.float32(u1 - u1_hi.astype(np.float64))]


def _assert_same(jax_out, torch_out):
    jax_out = jax_out if isinstance(jax_out, tuple) else (jax_out,)
    torch_out = torch_out if isinstance(torch_out, tuple) else (torch_out,)
    for a, b in zip(jax_out, torch_out):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_two_sum_bitwise_and_error_free():
    rng = np.random.default_rng(0)
    a = rng.normal(size=256) * 10.0 ** rng.integers(-6, 6, size=256)
    b = rng.normal(size=256) * 10.0 ** rng.integers(-6, 6, size=256)
    (aj, at), (bj, bt) = _pair(a), _pair(b)
    s, e = port.two_sum(at, bt)
    _assert_same(ref.two_sum(aj, bj), (s, e))
    exact = at.double() + bt.double()
    np.testing.assert_array_equal((s.double() + e.double()).numpy(),
                                  exact.numpy())


def test_two_product_bitwise_and_exact():
    rng = np.random.default_rng(0)
    (aj, at), (bj, bt) = _pair(rng.normal(size=512)), _pair(
        rng.normal(size=512))
    p, e = port.two_product(at, bt)
    _assert_same(ref.two_product(aj, bj), (p, e))
    np.testing.assert_array_equal((p.double() + e.double()).numpy(),
                                  (at.double() * bt.double()).numpy())


@pytest.mark.parametrize("name", ["dd_bdf2_predict", "dd_history_diff"])
def test_dd_history_ops_bitwise(name):
    pairs = [_pair(x) for x in _dd_inputs(1)]
    got = getattr(port, name)(*[t for _j, t in pairs])
    _assert_same(getattr(ref, name)(*[j for j, _t in pairs]), got)


def test_dd_bdf2_predict_accuracy():
    rng = np.random.default_rng(1)
    u = rng.normal(size=64)
    u1 = u + 1e-3 * rng.normal(size=64)
    parts = _dd_inputs(1)
    ph, pl = port.dd_bdf2_predict(*[torch.from_numpy(x) for x in parts])
    np.testing.assert_allclose((ph.double() + pl.double()).numpy(),
                               2 * u - u1, rtol=1e-13, atol=1e-13)


def test_dd_add_small_bitwise_and_tracks_sub_ulp_increments():
    hj, ht = _pair(np.ones(8))
    lj, lt = jnp.zeros_like(hj), torch.zeros_like(ht)
    dj, dtt = _pair(np.full(8, 1e-10))
    for _ in range(1000):
        hj, lj = ref.dd_add_small(hj, lj, dj)
        ht, lt = port.dd_add_small(ht, lt, dtt)
    _assert_same((hj, lj), (ht, lt))
    np.testing.assert_allclose((ht.double() + lt.double()).numpy(),
                               1.0 + 1000 * 1e-10, rtol=1e-9)


@pytest.mark.parametrize("m", [48, 13])
def test_dd_matvec_accuracy_and_parity(m):
    """f32 dd matvec within 1e-13 of the f64 matvec (padded and
    8-aligned widths), and within the same bound of the reference."""
    rng = np.random.default_rng(1)
    n, B = 48, 64
    Tj, Tt = _pair(rng.normal(size=(n, m)))
    x64 = rng.normal(size=(m, B))
    hij, hit = _pair(x64)
    lo = np.float32(x64 - np.float32(x64).astype(np.float64))
    loj, lot = _pair(lo)
    h, l = port.dd_matvec(Tt, hit, lot)
    got = h.double() + l.double()
    want = Tt.double() @ (hit.double() + lot.double())
    scale = want.abs().max()
    assert ((got - want).abs().max() / scale).item() < 1e-13
    rh, rl = ref.dd_matvec(Tj, hij, loj)
    rgot = np.asarray(rh, np.float64) + np.asarray(rl, np.float64)
    assert np.abs(rgot - got.numpy()).max() / scale.item() < 1e-13
