"""A whole run on the CPU, at a tiny size, with the timed path broken
underneath the entry, must come out not correct; the same run unbroken
comes out correct. The breaks are the faults a served cell can have: a
sweep whose state never moves, half of the batch left out (every other
lane given its neighbour's answer) and an answer altered where it is produced.
(A cell of one chip has no exchange between chips to leave out.) The
fleet routes through K1 as on the card (the precompute budget at 0), the
global ROM through K4."""

import copy
import time

import pytest

from benchmark import harness, run

pytest.importorskip("romtime_tpu_torch")
from romtime_tpu_torch.rom.engines import (  # noqa: E402
    global_fused,
    windowed_fused,
)
from romtime_tpu_torch.rom.rom import RomConstructorNonlinear  # noqa: E402

SWEEPS = {"fleet-uniform-b2048": (windowed_fused,
                                  "online_sweep_windowed_fused"),
          "global-n15-b2048": (global_fused, "online_sweep_pallas")}


def unchanged(orig, name):
    """The state never leaves its start: the probes are the lifting rows
    alone, the final state the initial one."""
    def sweep(*args, **kw):
        if name == "online_sweep_windowed_fused":
            off = kw["km8"] + kw["kk8"] + kw["kf8"]
            return args[0][:, off:off + 8].clone(), args[9].clone()
        g = args[3]
        return g.clone(), g.new_zeros((args[5].shape[-1], g.shape[-1]))
    return sweep


def half_batch(orig, name):
    """Every other lane left out, its neighbour's answer in its place
    (lanes, not the batch's second half: the router pads a cell's
    sub-batch by cycling its own μ, so its second half is often padding
    alone)."""
    def sweep(*args, **kw):
        probes, state = orig(*args, **kw)
        n = probes[..., 1::2].shape[-1]
        probes[..., 1::2] = probes[..., 0::2][..., :n]
        state[..., 1::2] = state[..., 0::2][..., :n]
        return probes, state
    return sweep


def altered(orig, name):
    """One step's probes of every lane moved by a thousandth of their
    scale where the sweep produces them."""
    def sweep(*args, **kw):
        probes, state = orig(*args, **kw)
        probes[probes.shape[0] // 2, :2] += 1e-3 * probes.abs().max()
        return probes, state
    return sweep


def tiny_run(name):
    work, config, mix = harness.load_cell(name)
    config = copy.deepcopy(config)
    config["fom"].update(nx=100, nt=60)
    if config["kind"] == "fleet":
        config["cells"] = [[2, 6]] * 4 + [[3, 8]] * 2
    work = copy.deepcopy(work)
    limits = work["check"]["limits"]
    for key in ("probe_gap", "state_gap", "state_gap_median"):
        if limits[key] is None:
            limits[key] = 1e-4
    return run.run_cell(name, work, config, dict(mix, batch=128),
                        2_147_483_661, 0.5, 0, "cpu", time.perf_counter())


def card_routing(monkeypatch, name):
    """Route as on the card: the fleet's cells on K1 (at the tiny size
    their tables would fit the budget and route to K2), the global ROM on
    K4 within the budget."""
    monkeypatch.setattr(RomConstructorNonlinear, "ONLINE_PRECOMPUTE_BUDGET",
                        0 if name.startswith("fleet") else 6 * 1024**3)


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_unbroken_run_is_correct(name, monkeypatch):
    card_routing(monkeypatch, name)
    module, attr = SWEEPS[name]
    orig, calls = getattr(module, attr), []

    def counted(*args, **kw):
        calls.append(1)
        return orig(*args, **kw)

    monkeypatch.setattr(module, attr, counted)
    res = tiny_run(name)
    assert res["correct"] is True, res["checks"]
    assert calls


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered])
@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_broken_run_is_not_correct(name, fault, monkeypatch):
    card_routing(monkeypatch, name)
    module, attr = SWEEPS[name]
    monkeypatch.setattr(module, attr, fault(getattr(module, attr), attr))
    res = tiny_run(name)
    assert res["correct"] is False, res["checks"]
