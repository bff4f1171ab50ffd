"""The plain reference and the seeded traffic at a tiny size on the CPU,
held against the port's own float64 engines on the same artifacts: the
frozen entry assembly against the reductors' gathered assembly, the
windowed sweep (every cell of a six-cell fleet, the registered one with
its dilation and guard) against the windowed lanes engine, the global
sweep against the global lanes engine, and the Mach bands against the
router's."""

import copy

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import assembly
from benchmark.reference.mach import band_edges
from benchmark.reference.sweep import cell_of, sweep_rows, tf32
from benchmark.traffic.artifacts import draw_payload
from benchmark.traffic.generator import Traffic, draw_mus, load_mix

pytest.importorskip("romtime_tpu_torch")
from romtime_tpu_torch import convert  # noqa: E402
from romtime_tpu_torch.dtypes import compute_dtype_scope  # noqa: E402
from romtime_tpu_torch.rom.rom import make_reductors  # noqa: E402

TINY = {"nx": 100, "nt": 60}
TINY_CELLS = [[2, 6]] * 4 + [[3, 8]] * 2
SEED = 2_345_678_901
#: float64 against float64: the same operators and solves in another
#: order.
F64_RTOL = 1e-12


def tiny(cell):
    work, config, mix = harness.load_cell(cell)
    config = copy.deepcopy(config)
    config["fom"].update(TINY)
    if config["kind"] == "fleet":
        config["cells"] = TINY_CELLS
    return work, config, dict(mix, batch=256)


def gap(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def test_assembly_matches_the_port_entries():
    _w, config, _m = tiny("fleet-uniform-b2048")
    nx = config["fom"]["nx"]
    fom = convert.piston_fom(L0=1.0, nx=nx, tf=1.0, nt=60, device="cpu")
    rng = np.random.default_rng(3)
    nh = nx + 1
    dofs = {}
    for name in assembly.SOURCES:
        rows = rng.choice(nh, size=8, replace=False)
        if name == "rhs_vec":
            dofs[name] = rows[:, None]
            continue
        cols = np.clip(rows + rng.integers(-1, 2, size=8), 0, nh - 1)
        dofs[name] = np.stack([rows, cols], axis=1)
    dofs["mass"][:2] = [[nh - 1, nh - 1], [nh - 1, nh - 2]]   # Dirichlet
    reductors = make_reductors(fom, dofs)
    B = 5
    mu = {"a0": rng.uniform(8, 10, B), "omega": rng.uniform(15, 20, B),
          "delta": rng.uniform(0.1, 0.15, B), "alpha": np.full(B, 1e-6),
          "gamma": np.full(B, 1.4)}
    mu = {k: torch.tensor(v) for k, v in mu.items()}
    t = torch.tensor(rng.uniform(0.0, 1.2, (7, B)))
    with compute_dtype_scope(torch.float64):
        for name in assembly.SOURCES:
            port = reductors[name]._entries_traced(mu, t)
            mine = assembly.entries(name, dofs[name], mu, t, nx)
            assert torch.allclose(mine, port, rtol=1e-12, atol=1e-15), name


def test_fleet_reference_matches_the_windowed_lanes_engine():
    _w, config, mix = tiny("fleet-uniform-b2048")
    payload = draw_payload(config, SEED, "cpu")
    rom = convert.fleet_serving_from_arrays(payload, device="cpu")
    batch = Traffic(mix, config["mu_box"], SEED).batch(0)
    cells = cell_of(payload, batch)
    mus = Traffic(mix, config["mu_box"], SEED).as_dicts(batch)
    with compute_dtype_scope(torch.float64):
        out = rom.solve_batch_mulocal(mus, mode="probes", engine="windowed")
    seen = set()
    for c in range(len(TINY_CELLS)):
        idx = np.nonzero(cells == c)[0][:4]
        if not len(idx):
            continue
        seen.add(c)
        ref = sweep_rows(payload, config, c, {k: v[idx]
                                              for k, v in batch.items()})
        assert gap([out["probes"][i] for i in idx],
                   ref["probes"].numpy()) < F64_RTOL
        assert gap([out["uN_final"][i] for i in idx],
                   ref["uN_final"].numpy()) < F64_RTOL
        if "dil" in ref:
            assert gap(out["dil"][idx], ref["dil"].numpy()) < F64_RTOL
            np.testing.assert_array_equal(out["dil_oor"][idx],
                                          ref["dil_oor"].numpy())
    assert {0, 5} <= seen


def test_global_reference_matches_the_global_lanes_engine():
    _w, config, mix = tiny("global-n15-b2048")
    payload = draw_payload(config, SEED, "cpu")
    k = config["dofs_per_source"]
    f64 = dict(payload)
    for name in config["sources"]:       # the float64 θ-solve: PᵀU = I
        f64[f"PT_U_{name}"] = np.eye(k)
        f64[f"basis_rom_{name}"] = payload[f"combine_{name}"]
    rom = convert.global_serving_from_arrays(f64, device="cpu")
    traffic = Traffic(dict(mix, batch=128), config["mu_box"], SEED)
    batch = traffic.batch(0)
    with compute_dtype_scope(torch.float64):
        out = rom.solve_batch(traffic.as_dicts(batch), mode="probes",
                              engine="lanes")
    idx = np.arange(6)
    ref = sweep_rows(payload, config, 0, {k: v[idx]
                                          for k, v in batch.items()})
    assert gap(out["probes"][idx], ref["probes"].numpy()) < F64_RTOL
    assert gap(out["uN_final"][idx], ref["uN_final"].numpy()) < F64_RTOL


def test_mach_bands_match_the_router():
    _w, config, mix = tiny("fleet-uniform-b2048")
    payload = draw_payload(config, SEED, "cpu")
    rom = convert.fleet_serving_from_arrays(payload, device="cpu")
    np.testing.assert_allclose(payload["edges"], band_edges(
        config["mu_box"], len(TINY_CELLS)), rtol=0, atol=0)
    batch = Traffic(mix, config["mu_box"], SEED).batch(0)
    mach = [rom.compute_piston_mach_number(m) for m in
            Traffic(mix, config["mu_box"], SEED).as_dicts(batch)]
    np.testing.assert_array_equal(rom.mulocal.cell_of(np.asarray(mach)),
                                  cell_of(payload, batch))


def test_traffic_is_seeded_and_the_band_mix_stays_in_its_band():
    _w, config, _m = tiny("fleet-onecell-b2048")
    mix = dict(load_mix("mach2-b2048"), batch=300)
    a = [Traffic(mix, config["mu_box"], SEED).batch(i) for i in (0, 1)]
    b = [Traffic(mix, config["mu_box"], SEED).batch(i) for i in (0, 1)]
    for x, y in zip(a, b):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    c = Traffic(mix, config["mu_box"], SEED + 1).batch(0)
    assert not np.array_equal(a[0]["a0"], c["a0"])
    payload = {"edges": band_edges(config["mu_box"], 6)}
    assert set(cell_of(payload, a[0]).tolist()) == {2}
    rng = np.random.default_rng(0)
    uniform = draw_mus({"region": {"kind": "box"}}, config["mu_box"],
                       20000, rng)
    shares = np.bincount(cell_of(payload, uniform), minlength=6) / 20000
    assert shares[2] > shares[0] > shares[5] > 0


def test_artifacts_are_seeded():
    _w, config, _m = tiny("fleet-uniform-b2048")
    a = draw_payload(config, SEED, "cpu")
    b = draw_payload(config, SEED, "cpu")
    c = draw_payload(config, SEED + 1, "cpu")
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["c0_trilinear"], c["c0_trilinear"])


def test_tf32_rounding_keeps_ten_mantissa_bits():
    """The TF32 control's operand rounding: the low 13 bits of every
    float32 cleared, to nearest, within half a TF32 unit."""
    x = torch.randn(4096, generator=torch.Generator().manual_seed(SEED))
    x = torch.cat([x, torch.tensor([1.0, 1 + 2**-11, -(1 + 2**-12)])])
    y = tf32(x)
    assert not (y.view(torch.int32) & 0x1FFF).any()
    assert ((y - x).abs() <= 2.0**-11 * x.abs()).all()
    assert y[-3:].tolist() == [1.0, 1 + 2**-10, -1.0]
    assert torch.equal(tf32(y), y)
