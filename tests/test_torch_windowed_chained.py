"""The port's chained windowed lanes variant
(``online_sweep_windowed_chained``,
romtime_tpu_torch/rom/engines/windowed_lanes.py) against the JAX
package's ``_online_sweep_windowed_chained``
(romtime_tpu/rom/engines/windowed_lanes.py:305-431), mirroring
test_windowed_chained_unequal_widths (tests/test_windowed.py:211): the
conftest piston pipeline (nx=150, nt=96, built by
tests/torch_parity.build_piston_hrom) rebuilt at W=5 windows of N=12,
widths 19/19/19/19/20. ``engine="windowed"`` dispatches to the chained
variant on unequal widths in both packages (reference :119-121); the
sweeps agree in every mode per output, at 1e-9·scale in float64 and
5e-6·scale in float32, and registered
(dilated) serving on unequal widths raises in both. On equal widths the
chained variant, called directly, meets the equal-width engine at
1e-9·scale in float64."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romtime_tpu.conventions import Stage
from romtime_tpu.dtypes import compute_dtype_scope
from romtime_tpu.rom.registration import DilationLaw as RefDilationLaw
from romtime_tpu_torch import DilationLaw, serving_from_arrays
from romtime_tpu_torch.dtypes import compute_dtype_scope as port_dtype_scope
from romtime_tpu_torch.rom.engines import windowed_lanes
from test_torch_serving import LAW_PAYLOAD
from torch_parity import (
    build_piston_hrom,
    clear_serving_caches,
    payload_from_rom,
    piston_mus,
)

@pytest.fixture(scope="module")
def chained_cell(tmp_path_factory):
    """(reference rom with the W=5 windows attached, its payload, the
    equal-width W=4 payload, μ batch)."""
    hrom = build_piston_hrom(tmp_path_factory.mktemp("torch_chained"))
    rom = hrom.rom
    equal = payload_from_rom(rom)
    rom.windows = None
    win = hrom.build_windowed_serving(n_windows=5, num_basis=12, dump=False)
    rom._set_serving_windows(win)
    clear_serving_caches(rom)
    widths = np.diff(win.bounds).tolist()
    assert widths == [19, 19, 19, 19, 20], widths
    return rom, payload_from_rom(rom), equal, piston_mus(3, seed=4)


DTYPES = {"float64": (jnp.float64, torch.float64, 1e-9),
          "float32": (jnp.float32, torch.float32, 5e-6)}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("mode", ["probes", "reduced", "full"])
def test_chained_matches_reference(chained_cell, monkeypatch, mode, dtype):
    """Every mode in both dtypes: float64 (the plain carry) at 1e-9·scale
    and float32 (the dd carry through unequal-width transfers) at
    5e-6·scale, per output."""
    rom, payload, _equal, mus = chained_cell
    jdt, tdt, tol = DTYPES[dtype]
    clear_serving_caches(rom)
    try:
        with compute_dtype_scope(jdt):
            want = rom.solve_batch(mus, step=Stage.VALIDATION, mode=mode,
                                   engine="windowed")
    finally:
        clear_serving_caches(rom)
    calls = []
    real = windowed_lanes.online_sweep_windowed_chained
    monkeypatch.setattr(windowed_lanes, "online_sweep_windowed_chained",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    port = serving_from_arrays(payload, device="cpu")
    with port_dtype_scope(tdt):
        got = port.solve_batch(mus, mode=mode, engine="windowed")
    assert calls == [1]
    assert set(got) == set(want)
    for key in want:
        w = np.asarray(want[key], dtype=np.float64)
        assert got[key].shape == w.shape, key
        scale = max(np.abs(w).max(), 1e-30)
        err = np.abs(np.asarray(got[key], dtype=np.float64) - w).max()
        print(f"chained {dtype} {mode} {key}: {err:.3e} (limit "
              f"{tol * scale:.3e})")
        assert err <= tol * scale, key


def test_registered_unequal_widths_raise(chained_cell):
    """Phase-aligned serving needs equal widths (reference :309-314): the
    chained variant refuses a dilation law in both packages."""
    rom, payload, _equal, mus = chained_cell
    saved = rom.windows
    rom.windows = dataclasses.replace(
        saved, dilation=RefDilationLaw.from_payload(**LAW_PAYLOAD))
    clear_serving_caches(rom)
    try:
        with pytest.raises(NotImplementedError, match="equal window widths"):
            rom.solve_batch(mus, step=Stage.VALIDATION, mode="probes",
                            engine="windowed")
    finally:
        rom.windows = saved
        clear_serving_caches(rom)
    port = serving_from_arrays(payload, device="cpu")
    port.windows.dilation = DilationLaw.from_payload(**LAW_PAYLOAD)
    with pytest.raises(NotImplementedError, match="equal window widths"):
        port.solve_batch(mus, mode="probes", engine="windowed")


@pytest.mark.parametrize("mode", ["probes", "full"])
def test_chained_on_equal_widths(chained_cell, mode):
    """The chained variant called directly on the equal-width cell (W=4)
    meets the equal-width engine at 1e-9·scale in float64."""
    _rom, _payload, equal, mus = chained_cell
    port = serving_from_arrays(equal, device="cpu")
    with port_dtype_scope(torch.float64):
        engine = port.solve_batch(mus, mode=mode, engine="windowed",
                                  host=False)
        chained = windowed_lanes.online_sweep_windowed_chained(
            port.fom, port.windows, port._theta_sources(),
            port._lanes_tables(mode), port._mu_batch(mus), mode)
    assert set(chained) == set(engine)
    for key, want in engine.items():
        scale = max(want.abs().max().item(), 1e-30)
        err = (chained[key] - want).abs().max().item()
        assert err <= 1e-9 * scale, (key, err, scale)
