"""K2 and K4 on the serving body, on the CPU: the arithmetic of
``csrc/resid_tables_serving.cu`` (K2) and ``csrc/global_tables_serving.cu``
(K4), their lane-major table layout, the engine's product that forms it,
and the wrappers' routing rule.

- The split twins ``sweep_v2_split`` (K2: N = T0·(dt·b0·pred), KL·pred and
  N·pred dotted apart) and ``sweep_split`` (K4: K4's order, the reference's
  Gauss-Jordan) are held against the reference kernels in interpret mode on
  the inputs of tests/test_torch_resid_sweep.py and
  tests/test_torch_global_sweep.py, at their tolerances: K2 at 2e-5·scale
  on probes and state registers 0 and 2 (N=12 and N=24, and two chained
  launches with step0 > 0 against one reference launch); K4 at
  2e-6·max(scale, 1) on probes and 1e-5 on uN (N=15), 5e-5·max(scale, 1)
  at N=9 with BDF-1 and no trilinear term, the padded probe rows and uN
  entries exact zeros.
- The engine's lane-major product (``window_operators_lanes``) equals the
  reference layout's einsum (``window_operators``) permuted, within 1e-6
  relative, with exact zeros in the padding columns; the twins give the
  same result from either layout.
- The lanes a block the wrappers pick, and the routing rule: the serving
  body for every call, the first design only on request, an unknown
  design raises, the card entries refuse CPU tensors.

The CUDA kernels themselves are held against the twins on the card
(tests/test_torch_cuda.py, marked ``cuda``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romtime_tpu.ops.pallas_online import (
    online_sweep_pallas as ref_k4,
    online_sweep_pallas_v2 as ref_k2,
)
from romtime_tpu_torch.ops import global_sweep as gs
from romtime_tpu_torch.ops import kernel_build
from romtime_tpu_torch.ops import resid_sweep as rs
from romtime_tpu_torch.rom.engines import windowed_fused as engine
from romtime_tpu_torch.testing.synthetic import global_tables, resid_tables
from test_pallas_online import _synthetic
from test_torch_global_sweep import _k4_args
from test_torch_resid_sweep import _k2_args, _operators, _state0
from test_torch_theta_split import _assert_k3_close, _torch, _window_serving


@pytest.mark.parametrize("N", [12, 24], ids=["gauss_jordan", "blocked_lu"])
def test_k2_split_twin_matches_reference_kernel(N):
    case = _operators(N, 16, seed=N + 41)
    args = _k2_args(case, N) + [_state0(N)]
    kw = dict(dt=case["dt"], step0=0, n_real=N)
    ref = ref_k2(*[jnp.asarray(a) for a in args], interpret=True, **kw)
    got = rs.sweep_v2_split(*_torch(args), **kw)
    _assert_k3_close([t.numpy() for t in got], [np.asarray(a) for a in ref])


def test_k2_split_twin_chained_matches_reference_kernel():
    """Two split-twin launches on lane-major tables chained through the dd
    state (the second from step0 = 8, BDF-2 from its first step) against
    one reference launch over the 16 steps."""
    N, NT, h = 24, 16, 8
    case = _operators(N, NT, seed=19)
    args = _k2_args(case, N)
    kw = dict(dt=case["dt"], n_real=N)
    ref = ref_k2(*[jnp.asarray(a) for a in args + [_state0(N)]],
                 interpret=True, step0=0, **kw)
    targs = _torch(args)
    tables = rs.lane_major(*targs[:3])

    def part(lo, hi):     # the tables and g lead the arguments
        return [t[lo:hi] for t in tables] + [targs[3][lo:hi]] + targs[4:]

    pa, sa = rs.sweep_v2_split(*part(0, h), torch.from_numpy(_state0(N)),
                               step0=0, lane_major=True, **kw)
    pb, sb = rs.sweep_v2_split(*part(h, NT), sa, step0=h, lane_major=True,
                               **kw)
    _assert_k3_close([torch.cat([pa, pb]).numpy(), sb.numpy()],
                     [np.asarray(a) for a in ref])


#: (N, NT, options, probe tolerance, uN tolerance) of the K4 cases.
K4_CASES = {
    "N9_bdf1_no_trilinear": (9, 16, {"bdf2": False,
                                     "with_trilinear": False}, 5e-5, None),
    "N15": (15, 16, {}, 2e-6, 1e-5),
}


@pytest.mark.parametrize("case_id", list(K4_CASES))
def test_k4_split_twin_matches_reference_kernel(case_id):
    N, NT, options, p_tol, u_tol = K4_CASES[case_id]
    B = 128
    case = _synthetic(N, NT, B, seed=N + 60)
    args = _k4_args(case, N, NT, B)
    kw = dict(dt=case[-1], n_real=N, **options)
    ref_p, ref_u = (np.asarray(a) for a in ref_k4(
        *[jnp.asarray(a) for a in args], interpret=True, **kw))
    probes, uN = (t.numpy() for t in gs.sweep_split(*_torch(args), **kw))
    assert np.isfinite(ref_p).all() and np.isfinite(ref_u).all()
    scale = max(float(np.abs(ref_p).max()), 1.0)
    np.testing.assert_allclose(probes[:, :2], ref_p[:, :2], rtol=0,
                               atol=p_tol * scale)
    u_atol = (u_tol if u_tol is not None
              else p_tol * max(np.abs(ref_u).max(), 1.0))
    np.testing.assert_allclose(uN[:N], ref_u[:N], rtol=0, atol=u_atol)
    assert np.abs(probes[:, 2:]).max() == 0.0
    assert np.abs(uN[N:]).max() == 0.0


def test_lane_major_product_matches_einsum():
    """The engine's lane-major product of a window's tables equals the
    reference layout's einsum, permuted, within 1e-6 relative; its padding
    columns are exact zeros."""
    win = _window_serving(seed=3)
    t = engine.windowed_tables(win, 0.01, engine.stiffness_side(win.combines),
                               "cpu")
    NP = t["VE"].shape[2]
    nt, B = 8, 6
    rng = np.random.default_rng(4)
    th = [torch.from_numpy(rng.normal(size=(nt, k, B)).astype(np.float32))
          for k in (t["km8"], t["kk8"], t["kf8"])]
    for w in range(win.n_windows):
        a, b = 2, 7
        want = rs.lane_major(*engine.window_operators(t, w, *th, a, b))
        got = engine.window_operators_lanes(t, w, *th, a, b)
        assert [x.shape for x in got] == [(b - a, B, NP, NP + 4)] * 2 + [
            (b - a, B, NP)]
        for x, y in zip(got, want):
            assert x.is_contiguous()
            assert (x - y).abs().max() <= 1e-6 * y.abs().max()
        assert not got[0][..., NP:].any() and not got[1][..., NP:].any()


def _table_cases():
    k2, k2kw = resid_tables(12, 5, 7, seed=2, device="cpu", step0=3)
    k4, k4kw = global_tables(9, 5, 7, seed=2, device="cpu")
    return ((rs.sweep_v2_reference, rs.sweep_v2_split, k2, k2kw),
            (gs.sweep_reference, gs.sweep_split, k4, k4kw))


@pytest.mark.parametrize("kernel", [0, 1], ids=["k2", "k4"])
def test_twins_agree_from_either_layout(kernel):
    """The twin and the split twin give the same result, bit for bit, from
    the reference layout and from the lane-major one (the wrapper's CPU
    route included), and no launch is counted."""
    twin, split, args, kw = _table_cases()[kernel]
    wrapper = (rs.online_sweep_pallas_v2, gs.online_sweep_pallas)[kernel]
    largs = (*rs.lane_major(*args[:3]), *args[3:])
    before = wrapper.launches
    for fn in (twin, split, wrapper):
        for x, y in zip(fn(*args, **kw), fn(*largs, **kw, lane_major=True)):
            assert torch.equal(x, y)
    assert wrapper.launches == before
    with pytest.raises(ValueError, match="lane-major MN/KL"):
        twin(*args, **kw, lane_major=True)


@pytest.mark.parametrize("B,NP,want", [(512, 32, 4), (128, 48, 4),
                                       (2048, 16, 16), (2048, 32, 16),
                                       (1000, 16, 8), (40, 64, 4),
                                       (130, 24, 4), (4096, 40, 8)])
def test_table_lanes_fill_the_card(B, NP, want):
    """The lanes a block of K2's and K4's serving body on a 132-SM card:
    the fewest lanes an SM, ties to the larger tile, never past the tile
    NP allows."""
    assert rs.pick_table_lanes(B, NP, 132) == want
    assert want <= rs.table_lanes_max(NP)


@pytest.mark.parametrize("options", [{}, {"with_trilinear": False},
                                     {"bdf2": False}],
                         ids=["bdf2_trilinear", "no_trilinear", "bdf1"])
@pytest.mark.parametrize("N", [8, 15, 32, 48])
def test_wrappers_route_cuda_calls_to_the_serving_body(monkeypatch, N,
                                                       options):
    """On a CUDA tensor K2's and K4's wrappers ask for the serving body
    from either layout, whatever the options and NP; the first-design
    entries ask for the first design; an unknown design raises. (The
    launch is replaced by a recorder: no card here.)"""
    asked = []
    monkeypatch.setattr(kernel_build, "device_route", lambda t: "cuda")
    monkeypatch.setattr(rs, "_launch_v2", lambda args, kw, design:
                        asked.append(("K2", design, kw["lane_major"])))
    monkeypatch.setattr(gs, "_launch_tables", lambda args, kw, design:
                        asked.append(("K4", design, kw["lane_major"])))
    k2, k2kw = resid_tables(N, 2, 3, device="cpu", **options)
    k4, k4kw = global_tables(N, 2, 3, device="cpu", **options)
    rs.online_sweep_pallas_v2(*k2, **k2kw)
    gs.online_sweep_pallas(*k4, **k4kw)
    rs.online_sweep_pallas_v2(*rs.lane_major(*k2[:3]), *k2[3:], **k2kw,
                              lane_major=True)
    rs._first_design_v2(*k2, **k2kw)
    gs._first_design_tables(*k4, **k4kw)
    assert asked == [("K2", "serving", False), ("K4", "serving", False),
                     ("K2", "serving", True), ("K2", "first", False),
                     ("K4", "first", False)]
    monkeypatch.undo()
    with pytest.raises(ValueError, match="unknown design"):
        rs._launch_v2(k2, rs._v2_options(**k2kw), "second")
    with pytest.raises(ValueError, match="unknown design"):
        gs._launch_tables(k4, gs._tables_options(**k4kw), "second")


def test_card_entries_refuse_cpu_tensors():
    """The first designs' yardsticks, the CLOCKED serving body and K2's
    forced lane tiles launch kernels only: on CPU tensors they raise and
    count nothing; the clocks exist at K2's NP 32/48 and K4's NP 16 only."""
    k2, k2kw = resid_tables(32, 2, 3, device="cpu")
    k4, k4kw = global_tables(15, 2, 3, device="cpu")
    wrappers = (rs.online_sweep_pallas_v2, gs.online_sweep_pallas)

    def counts():
        return [(w.launches, w.serving_launches, w.first_design_launches)
                for w in wrappers]

    before = counts()
    for entry, args, kw in ((rs._first_design_v2, k2, k2kw),
                            (rs._v2_clocked, k2, k2kw),
                            (gs._first_design_tables, k4, k4kw),
                            (gs._tables_clocked, k4, k4kw)):
        with pytest.raises(ValueError, match="device"):
            entry(*args, **kw)
    with pytest.raises(ValueError, match="device"):
        rs._v2_lanes(*k2, lanes=8, **k2kw)
    small, small_kw = resid_tables(12, 2, 3, device="cpu")
    with pytest.raises(ValueError, match="phase clocks"):   # NP=16
        rs._v2_clocked(*small, **small_kw)
    with pytest.raises(ValueError, match="phase clocks"):   # NP=24
        gs._tables_clocked(*global_tables(20, 2, 3, device="cpu")[0],
                           **k4kw)
    assert counts() == before
