"""The port's sharded windowed serving
(romtime_tpu_torch/parallel/sweep.py ``solve_online_windowed_sharded``),
its composition with the μ-local router (``solve_batch_mulocal``'s
``sweep_fn``) and the fleet build's sharded training sweep
(``build_mulocal_serving(mesh=...)``), on the CPU.

Mirrors tests/test_windowed.py:710-779 on the conftest windowed piston
cell (nx=150, nt=96, W=4 windows of N=12) built by the JAX package
(tests/torch_parity.build_piston_hrom) and carried to the port. The port
runs on ``DeviceMesh([cpu] * 8)``, the JAX package on its eight virtual
devices. Limits: sharded ≡ the single-device windowed engine at
1e-12·scale in float64 (9 μ over 8 shards: the batch pads), and at the
float32 lanes limit 5e-6·scale with the dd carry; sharded against the
JAX package's sharded sweep at the float64 lanes limit, 1e-9·scale;
routed-and-sharded rows equal each cell's direct single-device rows at
1e-12·scale, each cell served from its own tables; the fleet build's
sharded training sweep within tests/test_windowed.py:703-706's limits
of the one-batch build (Vs 1e-8·scale, trilinear 1e-6·scale).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from romtime_tpu.conventions import Stage
from romtime_tpu.parallel import device_mesh as ref_device_mesh
from romtime_tpu.parallel import (
    solve_online_windowed_sharded as ref_windowed_sharded,
)
from romtime_tpu.rom.rom import RomConstructorNonlinear as RefRCN
from romtime_tpu.rom.windowed import MuLocalWindowed as RefMuLocalWindowed
from romtime_tpu_torch import fleet_serving_from_arrays, serving_from_arrays
from romtime_tpu_torch.dtypes import compute_dtype_scope
from romtime_tpu_torch.parallel import (
    DeviceMesh,
    dryrun,
    solve_online_windowed_sharded,
)
from torch_parity import (
    build_piston_hrom,
    clear_serving_caches,
    payload_from_rom,
    piston_mus,
)

CPU = torch.device("cpu")
MESH = DeviceMesh([CPU] * 8)
#: Two μ in each Mach cell of the two-cell fleet (edges 0.15, 0.2625,
#: 0.375): the reference composition test's mu_lo and mu_hi and one more
#: of each.
FLEET_MUS = [dict(a0=9.8, omega=15.5, delta=0.10, alpha=1e-6, gamma=1.4),
             dict(a0=8.1, omega=19.5, delta=0.148, alpha=1e-6, gamma=1.4),
             dict(a0=9.6, omega=20.0, delta=0.15, alpha=1e-6, gamma=1.4),
             dict(a0=9.0, omega=16.0, delta=0.12, alpha=1e-6, gamma=1.4)]
FLEET_CELLS = [0, 1, 1, 0]


@pytest.fixture(scope="module")
def ref_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("Needs 8 virtual devices (see conftest XLA_FLAGS).")
    return ref_device_mesh(8)


@pytest.fixture(scope="module")
def piston_cell(tmp_path_factory):
    hrom = build_piston_hrom(tmp_path_factory.mktemp("torch_sharded"))
    return hrom, payload_from_rom(hrom.rom)


def _mus():
    return piston_mus(9, seed=11)


def _close(got, want, rel, keys=None):
    for k in keys or want:
        assert got[k].shape == want[k].shape, (k, got[k].shape)
        assert np.isfinite(got[k]).all(), k
        scale = max(np.abs(want[k]).max(), 1e-3)
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=rel * scale, err_msg=k)


@pytest.mark.parametrize("dtype,rel", [(torch.float64, 1e-12),
                                       (torch.float32, 5e-6)])
@pytest.mark.parametrize("mode", ["probes", "reduced", "full"])
def test_windowed_sharded_matches_single_device(piston_cell, mode, dtype,
                                                rel):
    _hrom, payload = piston_cell
    port = serving_from_arrays(payload, device="cpu")
    mus = _mus()
    with compute_dtype_scope(dtype):
        ref = port.solve_batch(mus, step=Stage.ONLINE, mode=mode,
                               engine="windowed")
        outs = solve_online_windowed_sharded(port, mus, mesh=MESH,
                                             mode=mode)
    assert set(outs) == set(ref)
    # The shared grid is rebuilt on the host in float64, as the
    # reference's; the engine's is in the compute dtype.
    assert outs["t"].shape == ref["t"].shape == (96,)
    np.testing.assert_array_equal(outs["t"],
                                  (np.arange(96) + 1) * (0.6 / 96))
    np.testing.assert_allclose(outs["t"], ref["t"], rtol=rel)
    _close(outs, ref, rel, [k for k in ref if k != "t"])
    assert all(outs[k].shape[0] == 9 for k in ref if k != "t")


@pytest.mark.parametrize("mode", ["probes", "reduced"])
def test_windowed_sharded_matches_reference(piston_cell, ref_mesh, mode):
    """Against the JAX package's sharded sweep on its 8 devices, float64,
    at the lanes limit."""
    hrom, payload = piston_cell
    rom = hrom.rom
    mus = _mus()
    clear_serving_caches(rom)
    want = ref_windowed_sharded(rom, [dict(m) for m in mus], mesh=ref_mesh,
                                mode=mode)
    port = serving_from_arrays(payload, device="cpu")
    with compute_dtype_scope(torch.float64):
        got = solve_online_windowed_sharded(port, mus, mesh=MESH, mode=mode)
    assert set(got) == set(want)
    _close(got, want, 1e-9)


@pytest.fixture(scope="module")
def fleet(piston_cell):
    """The JAX cell's served windows and its nested S-ROM windows as a
    two-cell fleet (mixed N: 12 and 16, both W=4 of equal widths), and
    the port's copy."""
    hrom, _payload = piston_cell
    rom, srom = hrom.rom, hrom.windows_srom
    edges = RefRCN.compute_piston_mach_number_space(rom.grid, 2)
    ml = RefMuLocalWindowed(edges=edges, cells=[rom.windows, srom])
    port = fleet_serving_from_arrays(payload_from_rom(rom, serving=ml),
                                     device="cpu")
    return rom, ml, port


def test_mulocal_sharded_composition(fleet):
    """Routed and sharded (the ``sweep_fn`` hook): each cell's rows equal
    that cell's direct single-device rows on the same padded sub-batch,
    each cell served from the tables cached on its own windows object
    (a swap of cells never serves another cell's tables)."""
    _rom, _ml, port = fleet
    mus = [dict(m) for m in FLEET_MUS]
    with compute_dtype_scope(torch.float64):
        outs = port.solve_batch_mulocal(
            mus, step=Stage.VALIDATION,
            sweep_fn=lambda sub: solve_online_windowed_sharded(
                port, sub, mesh=MESH, mode="probes"))
        prev = port.windows
        for c in (0, 1):
            idx = [i for i, cc in enumerate(FLEET_CELLS) if cc == c]
            sub = [dict(mus[i]) for i in idx] * 2
            port._set_serving_windows(port.mulocal.cells[c])
            direct = port.solve_batch(sub, step=Stage.VALIDATION,
                                      mode="probes", engine="windowed")
            for key in ("probes", "uN_final"):
                scale = np.abs(direct[key]).max()
                for j, i in enumerate(idx):
                    np.testing.assert_allclose(
                        outs[key][i], direct[key][j], rtol=0,
                        atol=1e-12 * scale, err_msg=f"cell {c} {key}")
        port._set_serving_windows(prev)
    for cell in port.mulocal.cells:
        keys = [k for k in cell._serving_tables if k[2] == "windowed"]
        assert {k[0] for k in keys} == {"cpu"}
        n = cell.N
        assert all(cell._serving_tables[k][1]["T"].shape[-1] == n
                   for k in keys)


def test_mulocal_sharded_matches_reference(fleet):
    """The routed sharded sweep against the JAX package's routed windowed
    engine on the same fleet, float64, at the lanes limit."""
    rom, ml, port = fleet
    mus = [dict(m) for m in FLEET_MUS]
    prev = rom.mulocal
    rom.mulocal = ml
    try:
        want = rom.solve_batch_mulocal([dict(m) for m in mus],
                                       step=Stage.VALIDATION, mode="probes",
                                       engine="windowed")
    finally:
        rom.mulocal = prev
        clear_serving_caches(rom)
    with compute_dtype_scope(torch.float64):
        got = port.solve_batch_mulocal(
            mus, step=Stage.VALIDATION,
            sweep_fn=lambda sub: solve_online_windowed_sharded(
                port, sub, mesh=MESH, mode="probes"))
    _close(got, want, 1e-9, ["probes"])
    # Mixed N: the final states stay a list of rows.
    for g, w in zip(got["uN_final"], want["uN_final"]):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-9 * max(np.abs(w).max(), 1e-3))


def test_windowed_sharded_refuses(piston_cell):
    """No windows, or windows of unequal widths, raise (the reference
    asserts both, tests/test_windowed.py:744-779's sweep)."""
    _hrom, payload = piston_cell
    port = serving_from_arrays(payload, device="cpu")
    win = port.windows
    bounds = np.asarray(win.bounds).copy()
    bounds[1] += 1
    port._set_serving_windows(dataclasses.replace(win, bounds=bounds))
    with pytest.raises(ValueError, match="equal window widths"):
        solve_online_windowed_sharded(port, _mus(), mesh=MESH)
    port._set_serving_windows(None)
    with pytest.raises(ValueError, match="no windowed serving"):
        solve_online_windowed_sharded(port, _mus(), mesh=MESH)


def test_fleet_build_sharded_training_sweep(tmp_path, monkeypatch):
    """``build_mulocal_serving(device_sweep=True, mesh=...)`` shards the
    training sweep and builds the cells of the one-batch build
    (tests/test_windowed.py:686-706)."""
    import romtime_tpu_torch.parallel.sweep as sweep

    hrom = dryrun.serving_hrom("cpu", workdir=tmp_path)
    monkeypatch.chdir(tmp_path)
    calls = []
    real = sweep.solve_fom_sharded
    monkeypatch.setattr(sweep, "solve_fom_sharded",
                        lambda *a, **kw: calls.append(kw["mesh"]) or
                        real(*a, **kw))

    def build(mesh):
        return hrom.build_mulocal_serving(
            device_sweep=True, mesh=mesh, rnd=np.random.RandomState(5),
            **dryrun.FLEET)

    batched = build(None)
    assert calls == []
    sharded = build(MESH)
    assert calls == [MESH]
    for a, b in zip(batched.cells, sharded.cells):
        scale = np.abs(a.Vs).max()
        np.testing.assert_allclose(b.Vs, a.Vs, atol=1e-8 * scale)
        np.testing.assert_allclose(b.trilinear, a.trilinear,
                                   atol=1e-6 * np.abs(a.trilinear).max())
