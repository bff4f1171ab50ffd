"""The port's global-basis serving (``engine="pallas"``) end to end against
the JAX reference, on the JAX-built piston cell of tests/conftest.py
(nx=150, nt=96), its global basis truncated to N=15 with the reference's
``truncate`` (the throughput ROM's N; N=35 costs the interpreted
reference ~17 s a call).

The reference serves through ``solve_batch(mode="probes",
engine="pallas")`` in f32 with its kernels in interpret mode
(tests/test_rom.py:175-227 setup); the port serves the same configuration
carried across as numpy (``convert.global_serving_from_arrays``), its
kernel twins on the CPU. Tolerances are the reference tests': probes
3e-5·scale and uN_final 1e-4·max(|uN|, 1) on the K4 branch
(test_solve_batch_pallas_engine), 3e-6·scale between the K5 and K4
branches (test_pallas_theta_branch_matches)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romtime_tpu.conventions import OperatorType, Stage
from romtime_tpu.dtypes import compute_dtype_scope
from romtime_tpu_torch import (
    global_serving_from_arrays,
    global_serving_to_arrays,
)
from romtime_tpu_torch.dtypes import compute_dtype_scope as port_dtype_scope
from romtime_tpu_torch.rom.engines import global_fused as engine
from romtime_tpu_torch.rom.engines.windowed_fused import materialized_bytes
from torch_parity import (
    build_piston_hrom,
    global_payload_from_rom,
    piston_mus,
)

N_GLOBAL = 15
B = 128

#: (operator type, reductor attribute) of the reference's piston ROM.
REDUCTORS = ((OperatorType.MASS, "mdeim_Mh"),
             (OperatorType.STIFFNESS, "mdeim_Ah"),
             (OperatorType.RHS, "deim_rhs"),
             (OperatorType.CONVECTION, "mdeim_Ch"),
             (OperatorType.NONLINEAR_LIFTING, "mdeim_Nh_hat"),
             (OperatorType.TRILINEAR, "mdeim_Nh"))


def _reference_solve(rom, mus, budget=None):
    """The reference's global pallas serving in f32 (interpret mode),
    with its precompute budget at ``budget`` when one is given."""
    cls = type(rom)
    saved = cls.ONLINE_PRECOMPUTE_BUDGET
    rom._online_fns = {}
    try:
        if budget is not None:
            cls.ONLINE_PRECOMPUTE_BUDGET = budget
        with compute_dtype_scope(jnp.float32):
            return rom.solve_batch(mus, step=Stage.ONLINE, mode="probes",
                                   engine="pallas")
    finally:
        cls.ONLINE_PRECOMPUTE_BUDGET = saved
        rom._online_fns = {}


@pytest.fixture(scope="module")
def global_cell(tmp_path_factory):
    """(reference ROM at N=15, payload, μ batch, reference outputs on the
    K4 and K5 branches)."""
    hrom = build_piston_hrom(tmp_path_factory.mktemp("torch_global"))
    full = hrom.rom
    rom = full.truncate(n=full.N - N_GLOBAL)
    for which, attr in REDUCTORS:
        rom.add_hyper_reductor(getattr(full, attr), which)
    rom.project_reductors()
    payload = global_payload_from_rom(rom)
    mus = piston_mus(B, seed=2)
    ref = {"matrices": _reference_solve(rom, mus),
           "thetas": _reference_solve(rom, mus, budget=0)}
    for out in ref.values():
        assert np.isfinite(out["probes"]).all()
        assert np.isfinite(out["uN_final"]).all()
    return rom, payload, mus, ref


def _port(payload):
    return global_serving_from_arrays(payload, device="cpu")


def test_solve_batch_pallas_engine_matches_reference(global_cell):
    """The K4 branch (the default budget holds the tables of B=128)."""
    _rom, payload, mus, ref = global_cell
    got = _port(payload).solve_batch(mus, mode="probes", engine="pallas")
    want = ref["matrices"]
    assert set(got) == set(want)
    assert got["probes"].shape == want["probes"].shape == (B, 96, 2)
    np.testing.assert_allclose(got["t"], want["t"], rtol=1e-6)
    scale = np.abs(want["probes"]).max()
    uscale = max(np.abs(want["uN_final"]).max(), 1.0)
    err = np.abs(got["probes"] - want["probes"]).max()
    uerr = np.abs(got["uN_final"] - want["uN_final"]).max()
    print(f"K4 branch vs reference: probes {err:.3e} (limit "
          f"{3e-5 * scale:.3e}), uN_final {uerr:.3e} (limit "
          f"{1e-4 * uscale:.3e})")
    assert err <= 3e-5 * scale
    assert uerr <= 1e-4 * uscale


def test_theta_branch_matches_reference_and_k4(global_cell):
    """The K5 branch (budget 0 on both sides) against the reference's K5
    branch and against the port's own K4 branch."""
    _rom, payload, mus, ref = global_cell
    port = _port(payload)
    k4 = port.solve_batch(mus, mode="probes")
    port.ONLINE_PRECOMPUTE_BUDGET = 0
    k5 = port.solve_batch(mus, mode="probes")
    for name, want in (("reference K5", ref["thetas"]), ("port K4", k4)):
        scale = max(np.abs(want["probes"]).max(), 1e-6)
        err = np.abs(k5["probes"] - want["probes"]).max()
        print(f"K5 branch vs {name}: probes {err:.3e} (limit "
              f"{3e-6 * scale:.3e})")
        assert err <= 3e-6 * scale


#: (B, budget, override, hard cap, branch) at nt=96, NP=16: the tables of
#: B lanes take materialized_bytes(96, 16, B) = 196608·B bytes.
ROUTES = [(128, None, None, None, "matrices"), (128, 0, None, None, "thetas"),
          (256, 196608 * 256, None, None, "matrices"),
          (256, 196608 * 256 - 1, None, None, "thetas"),
          (128, None, "thetas", None, "thetas"),
          (128, 0, "matrices", None, "matrices"),
          (128, 0, "matrices", 196608 * 128 - 1, "thetas")]


@pytest.mark.parametrize("B_,budget,override,cap,branch", ROUTES)
def test_global_routing(global_cell, monkeypatch, B_, budget, override, cap,
                        branch):
    """solve_batch launches the kernel of the reference's branch for (B,
    budget, autotune override, hard cap), seen through spies on the
    engine module."""
    _rom, payload, _mus_, _ref = global_cell
    assert materialized_bytes(96, 16, 1) == 196608
    port = _port(payload)
    if budget is not None:
        port.ONLINE_PRECOMPUTE_BUDGET = budget
    if cap is not None:
        port.ONLINE_PRECOMPUTE_HARD_CAP = cap
    port._precompute_override = override
    calls = []

    def spy(name):
        def sweep(fom, gs, prepped, tables):
            calls.append(name)
            nt, _k, b = prepped["THm"].shape
            NP = tables["VE"].shape[2]
            return torch.zeros((nt, 8, b)), torch.zeros((NP, b))
        return sweep

    monkeypatch.setattr(engine, "sweep_materialized", spy("matrices"))
    monkeypatch.setattr(engine, "sweep_theta", spy("thetas"))
    out = port.solve_batch(piston_mus(B_, seed=11), mode="probes")
    assert calls == [branch]
    assert out["probes"].shape == (B_, 96, 2)
    assert out["uN_final"].shape == (B_, N_GLOBAL)


def test_engine_gate(global_cell):
    """The gate of test_pallas_supported_gating: the global engine serves
    f32 batches of whole 128-lane blocks; elsewhere the port resolves to
    the reference's global lanes engine, "lanes", and serves there (the
    same probes as the K4 branch, within the reference's 3e-5·scale of
    test_solve_batch_pallas_engine). An explicit engine="pallas" serves
    any batch, and engine="lanes" serves a gated batch too."""
    rom, payload, _mus_, ref = global_cell
    port = _port(payload)
    with compute_dtype_scope(jnp.float32):
        assert rom._resolve_engine("probes", 128) == "pallas"
        assert rom._resolve_engine("probes", 100) == "lanes"
    assert port._resolve_engine("probes", 128) == "pallas"
    assert port._resolve_engine("probes", 100) == "lanes"
    assert port._resolve_engine("reduced", 128) == "lanes"
    lanes = port.solve_batch(_mus_[:100], mode="probes")
    assert lanes["probes"].shape == (100, 96, 2)
    want = ref["matrices"]["probes"][:100]
    scale = np.abs(want).max()
    assert np.abs(lanes["probes"] - want).max() <= 3e-5 * scale
    with port_dtype_scope(torch.float64):
        assert port._resolve_engine("probes", 128) == "lanes"
        out64 = port.solve_batch(_mus_[:4], mode="probes")
    assert out64["probes"].dtype == np.float64
    assert np.abs(out64["probes"] - want[:4]).max() <= 3e-5 * scale
    out = port.solve_batch(piston_mus(100), mode="probes", engine="pallas")
    assert out["probes"].shape == (100, 96, 2)
    assert np.isfinite(out["probes"]).all()
    forced = port.solve_batch(_mus_, mode="probes", engine="lanes")
    assert np.abs(forced["probes"] - ref["matrices"]["probes"]).max() <= (
        3e-5 * np.abs(ref["matrices"]["probes"]).max())


def test_autotune_online_precompute(global_cell, tmp_path):
    """test_autotune_online_precompute on the port: both variants serve
    and time, the winner is pinned and persists, load_autotune pins it
    again, and an unmeasured configuration stays on the static policy."""
    _rom, payload, _mus_, _ref = global_cell
    port = _port(payload)
    mus = piston_mus(B, seed=4)
    path = str(tmp_path / "autotune.json")
    rec = port.autotune_online_precompute(mus, n_rep=2, path=path)
    assert rec["winner"] in ("matrices", "thetas")
    assert set(rec["wall_s"]) == {"matrices", "thetas"}
    assert all(w > 0 for w in rec["wall_s"].values())
    assert rec["key"] == f"cpu|pallas|probes|N{N_GLOBAL}|B{B}|nt96|float32"
    assert port._precompute_override == rec["winner"]
    with open(path) as f:
        assert json.load(f) == {rec["key"]: {"winner": rec["winner"],
                                             "wall_s": rec["wall_s"]}}

    port._precompute_override = None
    rec2 = port.load_autotune(B, path=path)
    assert rec2 is not None and rec2["winner"] == rec["winner"]
    assert port._precompute_override == rec["winner"]
    port._precompute_override = None
    assert port.load_autotune(99, engine="pallas", path=path) is None
    assert port._precompute_override is None


def test_autotune_restores_override_on_failure(global_cell, monkeypatch,
                                               tmp_path):
    _rom, payload, _mus_, _ref = global_cell
    port = _port(payload)
    port._precompute_override = "thetas"

    def broken(*_a, **_k):
        raise RuntimeError("variant failed")

    monkeypatch.setattr(engine, "sweep_materialized", broken)
    with pytest.raises(RuntimeError, match="variant failed"):
        port.autotune_online_precompute(piston_mus(B), n_rep=1,
                                        path=str(tmp_path / "a.json"))
    assert port._precompute_override == "thetas"
    assert not (tmp_path / "a.json").exists()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_autotune_file_shared(global_cell, tmp_path, writer):
    """Each package reads the other's autotune record: same key, same
    record. The reference's writer runs its own code with its sweep
    stubbed (an interpreted sweep per timed call would cost minutes)."""
    rom, payload, _mus_, _ref = global_cell
    port = _port(payload)
    path = str(tmp_path / "autotune.json")
    mus = piston_mus(B, seed=5)
    try:
        with compute_dtype_scope(jnp.float32):
            if writer == "port":
                rec = port.autotune_online_precompute(mus, n_rep=1,
                                                      path=path)
                got = rom.load_autotune(B, mode="probes", engine="pallas",
                                        path=path)
                assert rom._precompute_override == rec["winner"]
            else:
                rom._get_online_fn = lambda **_kw: (
                    lambda batch: {"probes": batch["a0"]})
                rec = rom.autotune_online_precompute(
                    mus, mode="probes", engine="pallas", n_rep=2, path=path)
                got = port.load_autotune(B, path=path)
                assert port._precompute_override == rec["winner"]
    finally:
        rom._precompute_override = None
        rom.__dict__.pop("_get_online_fn", None)
        rom._online_fns = {}
    assert got == {"winner": rec["winner"], "wall_s": rec["wall_s"]}


def test_thetas_match_reference(global_cell):
    """Each source's θ(μ, t) in the f32 folded form the global engine
    streams (the reference's _thetas_traced under f32 serving: raw
    gathered entries), to 1e-5 of its largest entry (f32 assembly in a
    different op order)."""
    rom, payload, _mus_, _ref = global_cell
    port = _port(payload)
    mu = piston_mus(1, seed=6)[0]
    t = 0.37
    with compute_dtype_scope(jnp.float32):
        for name, red in port._theta_sources().items():
            ref_red = rom._theta_sources()[name][0]
            assert ref_red._folded_serving()
            want = np.asarray(ref_red._thetas_traced(
                {k: jnp.asarray(v, jnp.float32) for k, v in mu.items()},
                jnp.asarray(t, jnp.float32)))
            got = red._thetas_traced(
                {k: torch.tensor(v, dtype=torch.float32)
                 for k, v in mu.items()},
                torch.tensor(t, dtype=torch.float32)).numpy()
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=name)


def test_payload_roundtrip(global_cell):
    _rom, payload, _mus_, _ref = global_cell
    back = global_serving_to_arrays(_port(payload))
    assert set(back) == set(payload)
    for key in payload:
        np.testing.assert_array_equal(back[key], payload[key], err_msg=key)


def test_synthetic_global_cell_serves():
    """The seeded global cell that chip_smoke.py serves on the card, at a
    CPU size: the budget routes it, both branches agree, the pivot-free
    guard certifies cond₂(K_N) inside its bound."""
    from romtime_tpu_torch.testing.synthetic import (
        synthetic_global_cell,
        synthetic_mus,
    )

    rom = synthetic_global_cell(N=15, nx=100, nt=60, seed=3, device="cpu")
    mus = synthetic_mus(128, seed=4)
    out = rom.solve_batch(mus, mode="probes", probe_reduce="mean")
    assert out["probes"].shape == (128, 2)
    assert out["uN_final"].shape == (128, 15)
    assert np.isfinite(out["probes"]).all()
    assert 1.0 <= rom._pivot_cert <= rom.PIVOT_FREE_COND_BOUND / 1.3
    rom.ONLINE_PRECOMPUTE_BUDGET = 0
    theta = rom.solve_batch(mus, mode="probes", probe_reduce="mean")
    scale = np.abs(out["probes"]).max()
    np.testing.assert_allclose(theta["probes"], out["probes"], rtol=0,
                               atol=3e-6 * scale)


def test_full_width_routing():
    """At the throughput profile's shapes (nt=1500, B=2048) the 6 GiB
    budget takes the N=15 ROM (NP=16, 6.29e9 bytes) to K4 and the N=20
    S-ROM (NP=24, 1.42e10 bytes) to K5; a "matrices" override cannot take
    the S-ROM past the 12 GiB hard cap."""
    from romtime_tpu_torch.rom.engines.policy import PrecomputePolicy

    policy = PrecomputePolicy()
    assert engine.global_branch(1500, 16, 2048,
                                policy.precompute_choice) == "matrices"
    assert engine.global_branch(1500, 24, 2048,
                                policy.precompute_choice) == "thetas"
    policy._precompute_override = "matrices"
    assert engine.global_branch(1500, 24, 2048,
                                policy.precompute_choice) == "thetas"
    assert engine.global_branch(1500, 16, 4096,
                                policy.precompute_choice) == "matrices"
    policy._precompute_override = "thetas"
    assert engine.global_branch(1500, 16, 2048,
                                policy.precompute_choice) == "thetas"
