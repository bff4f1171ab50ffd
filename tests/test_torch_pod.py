"""The port's POD (romtime_tpu_torch/rom/pod.py ``orth``) and reduction
state (romtime_tpu_torch/rom/base.py ``Reductor``) against the JAX
package's, on seeded numpy matrices, the reference's SVD routed through
numpy (tests/torch_parity.py:22-24) as its own parity cells build.

Anchors: tests/test_pod_weighting.py:44 (the hierarchical weighting
keeps the energy ordering) and the truncation semantics of
romtime_tpu/rom/pod.py:34-91 (``tol``, ``num``, the dtype-aware floor;
``normalize``, ``return_VT``). Limits: σ within 1e-12·σ₁, the energy
within 1e-12, Q and VT within 1e-10 after sign alignment (singular
vectors are defined up to sign). A rank-1 float64 matrix keeps one mode
with finite σ; a non-finite σ raises ``FloatingPointError`` (a stated
departure: the reference keeps 0 modes there)."""

import jax.numpy as jnp
import numpy as np
import pytest

from romtime_tpu.rom import base as ref_base
from romtime_tpu.rom import pod as ref_pod
from romtime_tpu_torch.conventions import Stage, Treewalk, TreewalkNonlinear
from romtime_tpu_torch.rom import pod
from romtime_tpu_torch.rom.base import SUMMARY_COLUMNS, Reductor
from torch_parity import _numpy_svd


@pytest.fixture
def ref_orth(monkeypatch):
    monkeypatch.setattr(jnp.linalg, "svd", _numpy_svd)
    return ref_pod.orth


def _matrix(seed, m=60, n=40, rank=25, decay=-5, dtype=np.float64):
    """A seeded (m, n) matrix with a distinct, decaying spectrum (its
    smallest gap ~1e-6 of σ₁, so each singular vector is defined to
    ~1e-10 in float64)."""
    rng = np.random.default_rng(seed)
    U = np.linalg.qr(rng.normal(size=(m, rank)))[0]
    W = np.linalg.qr(rng.normal(size=(n, rank)))[0]
    return ((U * np.logspace(0, decay, rank)) @ W.T).astype(dtype)


def _aligned(got, want, axis):
    """``got`` with each singular vector's sign matched to ``want``'s."""
    signs = np.sign(np.sum(got * want, axis=axis, keepdims=True))
    return got * signs


def _check(got, want, n_vt=False):
    Q, s, energy = got[:3]
    Qr, sr, er = (np.asarray(a) for a in want[:3])
    assert Q.shape == Qr.shape
    assert np.isfinite(s).all()
    np.testing.assert_allclose(s, sr, rtol=0, atol=1e-12 * sr[0])
    np.testing.assert_allclose(energy, er, rtol=0, atol=1e-12)
    np.testing.assert_allclose(_aligned(Q, Qr, 0), Qr, rtol=0, atol=1e-10)
    if n_vt:
        VT, VTr = got[3], np.asarray(want[3])
        assert VT.shape == VTr.shape
        np.testing.assert_allclose(_aligned(VT, VTr, 1), VTr, rtol=0,
                                   atol=1e-10)


@pytest.mark.parametrize("kwargs", [
    dict(), dict(normalize=False), dict(num=7), dict(num=7, normalize=False),
    dict(tol=0.999999), dict(tol=0.9, normalize=False),
    dict(return_VT=True), dict(num=5, return_VT=True, normalize=False)],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "floor")
def test_orth_matches_reference(ref_orth, kwargs):
    """Every truncation mode, ``normalize`` and ``return_VT``
    (romtime_tpu/rom/pod.py:34-91)."""
    S = _matrix(seed=len(kwargs) + 3 * kwargs.get("num", 1))
    got = pod.orth(S, **kwargs)
    want = ref_orth(S, **kwargs)
    assert len(got) == len(want)
    _check(got, want, n_vt=kwargs.get("return_VT", False))


def test_orth_drop_floor_is_dtype_aware(ref_orth):
    """Without tol or num: σ ≤ max(1e-7, 50·eps·σ₁) is dropped — 1e-7 in
    float64, the float32 floor for a float32 matrix."""
    S64 = _matrix(seed=11, decay=-12)
    Q, s, _ = pod.orth(S64, normalize=False)
    assert Q.shape[1] == int((s > 1e-7).sum())
    assert Q.shape[1] == np.asarray(ref_orth(S64, normalize=False)[0]).shape[1]
    S32 = (S64 * 1e4).astype(np.float32)
    Q32, s32, _ = pod.orth(S32, normalize=False)
    floor = 50.0 * np.finfo(np.float32).eps * s32[0]
    assert floor > 1e-7
    assert Q32.dtype == np.float32
    assert Q32.shape[1] == int((s32 > floor).sum())
    Qr = np.asarray(ref_orth(S32, normalize=False)[0])
    assert Q32.shape[1] == Qr.shape[1]


def test_orth_rank_one_is_finite():
    """A rank-1 float64 matrix (the snapshots of an operator family that
    only scales, like the piston's mass): finite σ, one mode kept, the
    mode the matrix's own direction."""
    rng = np.random.default_rng(5)
    u, v = rng.normal(size=(300, 1)), rng.uniform(0.5, 2.0, size=(1, 96))
    Q, s, energy = pod.orth(u @ v, normalize=False)
    assert np.isfinite(s).all()
    assert Q.shape == (300, 1)
    np.testing.assert_allclose(energy[0], 1.0, atol=1e-12)
    np.testing.assert_allclose(np.abs(Q[:, 0]), np.abs(u[:, 0])
                               / np.linalg.norm(u), atol=1e-12)


def test_orth_raises_on_non_finite_sigma(monkeypatch):
    """The stated departure: an SVD returning a non-finite σ raises
    instead of truncating to 0 modes."""
    real = pod._host_svd

    def nan_svd(a):
        u, s, vt = real(a)
        s = s.copy()
        s[0] = np.nan
        return u, s, vt

    monkeypatch.setattr(pod, "_host_svd", nan_svd)
    with pytest.raises(FloatingPointError):
        pod.orth(_matrix(seed=2))


def test_orth_rejects_a_list():
    with pytest.raises(ValueError):
        pod.orth([[1.0, 2.0], [3.0, 4.0]])


def test_treewalk_keeps_energy_ordering():
    """tests/test_pod_weighting.py:44 on the port: the σ-weighted stack's
    second-stage POD recovers the leading direction."""
    rng = np.random.default_rng(0)
    U0 = np.linalg.qr(rng.normal(size=(50, 50)))[0]
    S = U0[:, :20] @ np.diag(np.logspace(0, -10, 20)) @ rng.normal(
        size=(20, 100))
    Q, s, _ = pod.orth(S)
    Q2, _s2, _ = pod.orth(Q * s[: Q.shape[1]], num=1, normalize=False)
    assert abs(float(Q2[:, 0] @ U0[:, 0])) > 0.999


def test_reductor_state_matches_reference():
    """``Reductor``: ``add_mu`` returns the appended index (duplicates
    get their own slot, the reference's deviation note), ``setup``'s
    report slots, and the error summary's four columns per
    μ equal to the reference's pandas table."""
    ref, port = ref_base.Reductor(grid=None), Reductor(grid=None)
    mu = {"a0": 9.0}
    for r in (ref, port):
        r.setup(rnd=3)
        assert r.add_mu(Stage.OFFLINE, mu)[0] == 0
        assert r.add_mu(Stage.OFFLINE, dict(mu))[0] == 1
    assert port.mu_space == ref.mu_space
    assert port.random_state == 3
    for walk in (Treewalk, TreewalkNonlinear):
        assert port.report[Stage.OFFLINE][walk.BASIS_TIME] == {}
        assert port.report[Stage.OFFLINE][walk.SPECTRUM_MU] is None
    assert set(port.report[Stage.OFFLINE]) == set(ref.report[Stage.OFFLINE])

    rng = np.random.default_rng(1)
    for r in (ref, port):
        r.errors_rom.clear()
    for i in range(3):
        series = rng.uniform(size=10)
        ref.errors_rom[i] = series
        port.errors_rom[i] = series
    ref.create_errors_summary()
    summary = port.create_errors_summary()
    table = ref.summary_errors
    assert list(table.columns) == list(SUMMARY_COLUMNS)
    assert summary["index"] == list(table.index)
    for col in SUMMARY_COLUMNS:
        np.testing.assert_allclose(summary[col], table[col].to_numpy(),
                                   rtol=1e-15)
