"""K3 and K5 on the serving body, on the CPU: the arithmetic of
``csrc/windowed_serving.cu`` (K3) and ``csrc/global_serving.cu`` (K5),
their operand layout and the wrappers' routing rule.

- The split twins ``theta_sweep_v2_split`` (K3) and ``theta_sweep_split``
  (K5) step in the serving body's segment order (K3: N = T0·(dt·b0·pred),
  KL·pred and N·pred dotted apart; K5: KN in the reference's order,
  bN = MN·combo + fN, its Gauss-Jordan). Each is held
  against the reference kernel in interpret mode on the inputs of
  tests/test_torch_resid_sweep.py and tests/test_torch_global_sweep.py,
  at their tolerances: K3 at 2e-5·scale on probes and state registers 0
  and 2 (N=12 and N=24, and two chained launches with step0 > 0 against
  one reference launch); K5 at 2e-6·max(scale, 1) on probes and 1e-5 on
  uN (N=15, N=20), 5e-5·max(scale, 1) at N=9 with BDF-1 and no trilinear
  term, the padded probe rows and uN entries exact zeros.
- The fold of (Bm, Bk, T0) equals the windowed engine's
  ``tables["Bmk"]``, the padded operands keep it row for row, and the
  live θ rows the engine passes (``live_rows``) give the twin's result on
  the engine's own tables.
- The routing rule: the serving body for every option, the first design
  only on request; the card entries refuse CPU tensors.

The CUDA kernels themselves are held against the twins on the card
(tests/test_torch_cuda.py, marked ``cuda``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romtime_tpu.ops.pallas_online import (
    online_sweep_theta_pallas as ref_k5,
    online_sweep_theta_pallas_v2 as ref_k3,
)
from romtime_tpu_torch.ops import global_sweep as gs
from romtime_tpu_torch.ops import kernel_build
from romtime_tpu_torch.ops import resid_sweep as rs
from romtime_tpu_torch.ops.windowed_fused import PROBE_P, pad_dim
from romtime_tpu_torch.rom.engines import windowed_fused as engine
from romtime_tpu_torch.rom.windowed import WindowedServing
from romtime_tpu_torch.testing.synthetic import global_tables, resid_tables
from test_pallas_online import _synthetic
from test_torch_global_sweep import _k5_args
from test_torch_resid_sweep import _k3_args, _state0, _theta_case


def _torch(args):
    return [torch.from_numpy(np.array(a)) for a in args]


def _assert_k3_close(got, want, atol_rel=2e-5):
    (gp, gst), (wp, wst) = got, want
    assert np.isfinite(wp).all() and np.isfinite(wst).all()
    scale = max(np.abs(wp).max(), 1e-6)
    np.testing.assert_allclose(gp, wp, rtol=0, atol=atol_rel * scale)
    sscale = np.abs(wst[[0, 2]]).max()
    np.testing.assert_allclose(gst[[0, 2]], wst[[0, 2]], rtol=0,
                               atol=atol_rel * sscale)


@pytest.mark.parametrize("N", [12, 24], ids=["gauss_jordan", "blocked_lu"])
def test_k3_split_twin_matches_reference_kernel(N):
    case = _theta_case(N, 24, seed=N + 31)
    args = _k3_args(case, N) + [_state0(N)]
    kw = dict(dt=case["dt"], step0=0, n_real=N)
    ref = ref_k3(*[jnp.asarray(a) for a in args], interpret=True, **kw)
    got = rs.theta_sweep_v2_split(*_torch(args), **kw)
    _assert_k3_close([t.numpy() for t in got], [np.asarray(a) for a in ref])


def test_k3_split_twin_chained_matches_reference_kernel():
    """Two split-twin launches chained through the dd state (the second
    from step0 = 12, BDF-2 from its first step) against one reference
    launch over the 24 steps."""
    N, NT, h = 24, 24, 12
    case = _theta_case(N, NT, seed=9)
    args = _k3_args(case, N)
    kw = dict(dt=case["dt"], n_real=N)
    ref = ref_k3(*[jnp.asarray(a) for a in args + [_state0(N)]],
                 interpret=True, step0=0, **kw)
    targs = _torch(args)

    def part(lo, hi):     # the θ streams and g lead the arguments
        return [a[lo:hi] if i < 4 else a for i, a in enumerate(targs)]

    pa, sa = rs.theta_sweep_v2_split(*part(0, h),
                                     torch.from_numpy(_state0(N)),
                                     step0=0, **kw)
    pb, sb = rs.theta_sweep_v2_split(*part(h, NT), sa, step0=h, **kw)
    _assert_k3_close([torch.cat([pa, pb]).numpy(), sb.numpy()],
                     [np.asarray(a) for a in ref])


#: (N, NT, options, probe tolerance, uN tolerance) of the K5 cases.
K5_CASES = {
    "N9_bdf1_no_trilinear": (9, 16, {"bdf2": False,
                                     "with_trilinear": False}, 5e-5, None),
    "N15": (15, 16, {}, 2e-6, 1e-5),
    "N20_NP24": (20, 12, {}, 2e-6, 1e-5),
}


@pytest.mark.parametrize("case_id", list(K5_CASES))
def test_k5_split_twin_matches_reference_kernel(case_id):
    N, NT, options, p_tol, u_tol = K5_CASES[case_id]
    B = 128
    case = _synthetic(N, NT, B, seed=N + 50)
    args = _k5_args(case, N, NT, B)
    kw = dict(dt=case[-1], n_real=N, **options)
    ref_p, ref_u = (np.asarray(a) for a in ref_k5(
        *[jnp.asarray(a) for a in args], interpret=True, **kw))
    probes, uN = (t.numpy() for t in gs.theta_sweep_split(*_torch(args),
                                                          **kw))
    assert np.isfinite(ref_p).all() and np.isfinite(ref_u).all()
    scale = max(float(np.abs(ref_p).max()), 1.0)
    np.testing.assert_allclose(probes[:, :2], ref_p[:, :2], rtol=0,
                               atol=p_tol * scale)
    u_atol = (u_tol if u_tol is not None
              else p_tol * max(np.abs(ref_u).max(), 1.0))
    np.testing.assert_allclose(uN[:N], ref_u[:N], rtol=0, atol=u_atol)
    assert np.abs(probes[:, 2:]).max() == 0.0
    assert np.abs(uN[N:]).max() == 0.0


def _window_serving(N=12, W=2, nh=20, seed=0):
    """A small windowed configuration with two stiffness-side sources:
    mass and stiffness combines near the identity (K = bdf·M + dt·S
    diagonally dominant), a trilinear table and a right-hand side."""
    rng = np.random.default_rng(seed)
    eye = np.eye(N).reshape(N * N, 1)

    def combine(k, diag):
        C = 0.02 * rng.normal(size=(W, N * N, k))
        C[:, :, :1] += diag * eye
        return C

    return WindowedServing(
        bounds=np.array([0, 4, 8][:W + 1]), Vs=rng.normal(size=(W, nh, N)),
        transfers=rng.normal(size=(W - 1, N, N)),
        combines={"mass": combine(3, 1.0), "stiffness": combine(4, 2.0),
                  "convection": combine(2, 0.0),
                  "rhs_vec": rng.normal(size=(W, N, 5))},
        trilinear=0.02 * rng.normal(size=(W, N * N, N)))


def test_fold_equals_engine_tables():
    win = _window_serving()
    stiff = engine.stiffness_side(win.combines)
    t = engine.windowed_tables(win, 0.01, stiff, "cpu")
    NP = pad_dim(win.N)
    assert engine.live_rows(t) == {"km": 3, "kk": 4 + 2 + 1}
    for w in range(win.n_windows):
        fold = rs.fold_combines(t["Bm"][w], t["Bk"][w], t["T0"][w], True)
        assert torch.equal(fold.T, t["Bmk"][w])
        nt, B = 3, 5
        th = [torch.ones((nt, k, B)) for k in (t["km8"], t["kk8"], t["kf8"],
                                                PROBE_P)]
        TH, Bmk, BfT, VE = rs.serving_operands(
            *th, t["Bm"][w], t["Bk"][w], t["Bf"][w], t["T0"][w],
            t["VE"][w], True)
        assert TH.shape == (nt, t["km8"] + t["kk8"] + t["kf8"] + PROBE_P, B)
        assert torch.equal(Bmk[0, :, :, :NP].reshape(-1, NP * NP),
                           t["Bmk"][w])
        assert Bmk.shape[-1] == NP + 4 and not Bmk[..., NP:].any()
        assert torch.equal(BfT[0], t["BfT"][w])
        assert torch.equal(VE[0, :, :NP], t["VE"][w])
        no_tri = rs.fold_combines(t["Bm"][w], t["Bk"][w], t["T0"][w], False)
        assert no_tri.shape == (NP * NP, t["km8"] + t["kk8"])


def test_live_rows_on_engine_tables_match_the_twin():
    """K3's split twin over only the live θ rows of the engine's window
    tables (the constant-1 θk row included) against the reference twin
    over the padded extents, on θ streams laid out as the prep lays them
    out (zeros in the padded rows)."""
    win = _window_serving(seed=1)
    dt = 0.01
    t = engine.windowed_tables(win, dt, engine.stiffness_side(win.combines),
                               "cpu")
    live = engine.live_rows(t)
    NP = pad_dim(win.N)
    nt, B = 6, 7
    rng = np.random.default_rng(2)

    def stream(k8, k, ones_row=None):
        th = np.zeros((nt, k8, B), np.float32)
        th[:, :k] = 1.0 + 0.05 * rng.normal(size=(nt, k, B))
        if ones_row is not None:
            th[:, ones_row] = 1.0
        return torch.from_numpy(th)

    THm = stream(t["km8"], live["km"])
    THk = stream(t["kk8"], live["kk"] - 1, ones_row=live["kk"] - 1)
    THf = stream(t["kf8"], 5)
    g = torch.zeros((nt, PROBE_P, B))
    b0 = torch.ones((1, B))
    state0 = torch.zeros((4, NP, B))
    args = (THm, THk, THf, g, t["Bm"][0], t["Bk"][0], t["Bf"][0],
            t["T0"][0], t["VE"][0], b0, state0)
    kw = dict(dt=dt, n_real=win.N)
    got = rs.theta_sweep_v2_split(*args, **kw, **live)
    want = rs.theta_sweep_v2_reference(*args, **kw)
    _assert_k3_close([x.numpy() for x in got], [x.numpy() for x in want])
    with pytest.raises(ValueError, match="live θ rows"):
        rs.theta_sweep_v2_split(*args, **kw, km=t["km8"] + 1)


@pytest.mark.parametrize("design", [None, "serving", "first", "second"])
def test_routing_rule(design):
    """The serving body for every call, the first design on request only;
    an unknown design raises."""
    if design == "second":
        with pytest.raises(ValueError, match="unknown design"):
            rs.theta_design(design)
        return
    assert rs.theta_design(design) == (design or "serving")


@pytest.mark.parametrize("options", [{}, {"with_trilinear": False},
                                     {"bdf2": False}],
                         ids=["bdf2_trilinear", "no_trilinear", "bdf1"])
@pytest.mark.parametrize("N", [8, 12, 20, 32, 44, 60])
def test_wrappers_route_cuda_calls_to_the_serving_body(monkeypatch, N,
                                                       options):
    """On a CUDA tensor each wrapper asks for the serving body whatever the
    options and NP; the first-design entries ask for the first design.
    (The launch is replaced by a recorder: no card here.)"""
    asked = []
    monkeypatch.setattr(kernel_build, "device_route", lambda t: "cuda")
    monkeypatch.setattr(rs, "_launch_theta_v2",
                        lambda args, kw, design: asked.append(("K3", design)))
    monkeypatch.setattr(gs, "_launch_theta",
                        lambda args, kw, design: asked.append(("K5", design)))
    k3, k3kw = resid_tables(N, 2, 3, device="cpu", theta=True, **options)
    k5, k5kw = global_tables(N, 2, 3, device="cpu", theta=True, **options)
    rs.online_sweep_theta_pallas_v2(*k3, **k3kw)
    gs.online_sweep_theta_pallas(*k5, **k5kw)
    rs._first_design_theta_v2(*k3, **k3kw)
    gs._first_design_theta(*k5, **k5kw)
    assert asked == [("K3", "serving"), ("K5", "serving"), ("K3", "first"),
                     ("K5", "first")]


def test_card_entries_refuse_cpu_tensors():
    """The first designs' yardsticks and the CLOCKED serving body launch
    kernels only: on CPU tensors they raise and count nothing."""
    k3, k3kw = resid_tables(32, 2, 3, device="cpu", theta=True)
    k5, k5kw = global_tables(20, 2, 3, device="cpu", theta=True)
    small, small_kw = resid_tables(12, 2, 3, device="cpu", theta=True)
    wrappers = (rs.online_sweep_theta_pallas_v2, gs.online_sweep_theta_pallas)

    def counts():
        return [(w.launches, w.serving_launches, w.first_design_launches)
                for w in wrappers]

    before = counts()
    for entry, args, kw in ((rs._first_design_theta_v2, k3, k3kw),
                            (rs._theta_v2_clocked, k3, k3kw),
                            (gs._first_design_theta, k5, k5kw),
                            (gs._theta_clocked, k5, k5kw)):
        with pytest.raises(ValueError, match="device"):
            entry(*args, **kw)
    with pytest.raises(ValueError, match="phase clocks"):   # NP=16
        rs._theta_v2_clocked(*small, **small_kw)
    with pytest.raises(ValueError, match="phase clocks"):   # NP=32
        gs._theta_clocked(*global_tables(32, 2, 3, device="cpu",
                                         theta=True)[0], **k5kw)
    assert counts() == before
