"""K1's serving design on the CPU: the arithmetic of
``csrc/windowed_serving.cu`` (the trilinear term formed once, r0 from the
build's own segments) and the wrapper's routing rule.

- The three identities the design rests on, in float64 to 1e-12 of their
  scale, on the reference's own windowed tables of the conftest piston
  cell (tests/torch_parity.py ``build_piston_hrom``, built by the JAX
  package) and on ``kernel_tables`` at NP ∈ {16, 32}:
  TQ·vec(p⊗p) = N·p, Σθm_k·BmF_k·d = MN·d and Σθk_k·BkF_k·p = KL·p, with
  MN, KL and N the mass, stiffness and T0 segments of the folded combine
  Bmk.
- The twin's sweep stepping with ``bdf_step_split`` against the reference
  kernel in interpret mode (tests/test_pallas_online.py's synthetic
  tables, reused from tests/test_torch_windowed_fused.py) at 5e-5·scale
  for probes and state: the per-step LU, the paired LU G=5 ``sub1``
  (width 8 ≥ G+2) and the Richardson solve (6 iterations), N ∈ {12, 24}.
- :func:`k1_design` for every follower mode × ablation × solve.

The CUDA kernel itself is held against the twin on the card
(tests/test_torch_cuda.py, marked ``cuda``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romtime_tpu.ops.pallas_online import (
    _chunk_capped,
    online_sweep_windowed_fused as ref_sweep,
)
from romtime_tpu_torch.ops import windowed_fused as k1
from romtime_tpu_torch.testing.synthetic import kernel_tables
from test_torch_windowed_fused import WIDTH, _tables
from torch_parity import build_piston_hrom, piston_mus, reference_prep

REL = 1e-12


def _identities(Bmk, BmF, BkF, TQ, km8, kk8, rng):
    """Largest relative gap of each identity over the windows of the
    float64 tables, at seeded θ, d and p."""
    W, kfold, NP2 = Bmk.shape
    NP = TQ.shape[1]
    km = BmF.shape[2] // NP
    kk = BkF.shape[2] // NP
    kmk8 = km8 + kk8
    gaps = {"trilinear": 0.0, "mass": 0.0, "stiffness": 0.0}
    for w in range(W):
        th_m = rng.normal(size=km)
        th_k = rng.normal(size=kk)
        d = rng.normal(size=NP)
        p = rng.normal(size=NP)
        BmkT = Bmk[w].T                                   # (NP², kfold)
        N = (BmkT[:, kmk8:kmk8 + NP] @ p).reshape(NP, NP)
        MN = (BmkT[:, :km] @ th_m).reshape(NP, NP)
        KL = (BmkT[:, km8:km8 + kk] @ th_k).reshape(NP, NP)
        pairs = {
            "trilinear": (TQ[w] @ np.outer(p, p).ravel(), N @ p),
            "mass": (((BmF[w].T @ d).reshape(km, NP) * th_m[:, None])
                     .sum(axis=0), MN @ d),
            "stiffness": (((BkF[w].T @ p).reshape(kk, NP) * th_k[:, None])
                          .sum(axis=0), KL @ p),
        }
        for name, (lhs, rhs) in pairs.items():
            scale = max(np.abs(lhs).max(), 1e-300)
            gaps[name] = max(gaps[name], np.abs(lhs - rhs).max() / scale)
    return gaps


@pytest.fixture(scope="module")
def reference_tables(tmp_path_factory):
    rom = build_piston_hrom(tmp_path_factory.mktemp("torch_k1_split")).rom
    tables, _ = reference_prep(rom, piston_mus(4))
    return tables


def test_identities_on_reference_tables(reference_tables):
    t = reference_tables
    km8, kk8 = t["Bm"].shape[2], t["Bk"].shape[2]
    NP = t["TQ"].shape[1]
    assert t["Bmk"].shape[1] == km8 + kk8 + NP, "the cell has a trilinear"
    gaps = _identities(*(np.asarray(t[k], np.float64)
                         for k in ("Bmk", "BmF", "BkF", "TQ")), km8, kk8,
                       np.random.default_rng(0))
    assert max(gaps.values()) <= REL, gaps


@pytest.mark.parametrize("N", [12, 32], ids=["NP16", "NP32"])
def test_identities_on_kernel_tables(N):
    args, kw = kernel_tables(N, 3, 4, 8, seed=N, device="cpu")
    assert args[5].shape[1] == k1.pad_dim(N)
    gaps = _identities(*(a.double().numpy() for a in
                         (args[1], args[2], args[3], args[5])),
                       kw["km8"], kw["kk8"], np.random.default_rng(N))
    assert max(gaps.values()) <= REL, gaps


#: (paired-LU group, Richardson iterations) of the split sweep cases.
SOLVES = {"lu": (None, None), "sub1": (5, None), "richardson": (None, 6)}


@pytest.mark.parametrize("solve", list(SOLVES))
@pytest.mark.parametrize("N", [12, 24])
def test_split_twin_matches_reference_kernel(N, solve):
    group, iters = SOLVES[solve]
    period = _chunk_capped(WIDTH, 8)
    if group:
        roles = k1.step_roles(period, group)
        assert roles.count("lead") == 1 and roles.count("follow") == 4
    args, kw = _tables(N, seed=N + 3, smooth=True)
    ref_p, ref_s = ref_sweep(*[jnp.asarray(a) for a in args], **kw,
                             interpret=True, paired_lu=group,
                             solve_iters=iters)
    ref_p, ref_s = np.asarray(ref_p), np.asarray(ref_s)
    assert np.isfinite(ref_p).all() and np.isfinite(ref_s).all()
    got_p, got_s = k1.windowed_fused_reference(
        *[torch.from_numpy(a) for a in args], **kw, paired_lu=group,
        solve_iters=iters, period=period, split=True)
    got_p, got_s = got_p.numpy(), got_s.numpy()
    scale = max(np.abs(ref_p).max(), 1e-6)
    np.testing.assert_allclose(got_p, ref_p, rtol=0, atol=5e-5 * scale)
    sscale = np.abs(ref_s[[0, 2]]).max()
    np.testing.assert_allclose(got_s[[0, 2]], ref_s[[0, 2]], rtol=0,
                               atol=5e-5 * sscale)


@pytest.mark.parametrize("solve_iters", [None, 5], ids=["lu", "richardson"])
@pytest.mark.parametrize("ablate", (None,) + k1.ABLATE_MODES)
@pytest.mark.parametrize("mode", k1.PAIRED_MODES)
def test_routing_rule(mode, ablate, solve_iters):
    """The serving design takes no ablation with no paired group or sub1
    followers, under either solve; the first design the rest. N=24 so
    that the LU schedule pairs (N > 20); Richardson and any ablation turn
    pairing off."""
    args, kw = kernel_tables(24, 2, 8, 4, seed=1, device="cpu")
    group = k1._check_args(*args, kw["widths"], True, kw["km8"], kw["kk8"],
                           kw["kf8"], 5, mode, None, 24, solve_iters,
                           ablate)[-1]
    assert group == (5 if solve_iters is None and ablate is None else 0)
    want = ("serving" if ablate is None
            and (mode == "sub1" or solve_iters is not None) else "first")
    assert k1.k1_design(group, mode, ablate) == want
    # No pairing at N ≤ 20: every mode without an ablation is served.
    assert k1.k1_design(0, mode, None) == "serving"


def test_card_entries_refuse_cpu_tensors():
    """The first design's yardstick and the clocked serving design launch
    kernels only; on a CPU tensor they raise, and count nothing."""
    args, kw = kernel_tables(32, 2, 4, 4, seed=2, device="cpu")
    small = kernel_tables(12, 2, 4, 4, seed=2, device="cpu")
    counts = (k1.online_sweep_windowed_fused.launches,
              k1.online_sweep_windowed_fused.serving_launches,
              k1.online_sweep_windowed_fused.first_design_launches)
    with pytest.raises(ValueError, match="device"):
        k1._first_design_sweep(*args, **kw)
    with pytest.raises(ValueError, match="device"):
        k1._serving_sweep_clocked(*args, **kw)
    with pytest.raises(ValueError, match="serving options"):
        k1._serving_sweep_clocked(*args, **kw, ablate="no_solve")
    with pytest.raises(ValueError, match="NP in"):     # NP=16
        k1._serving_sweep_clocked(*small[0], **small[1])
    assert counts == (k1.online_sweep_windowed_fused.launches,
                      k1.online_sweep_windowed_fused.serving_launches,
                      k1.online_sweep_windowed_fused.first_design_launches)
