"""The frozen bound arithmetic against ``chip_smoke.py``'s ``k1_bound`` and
``k4_bound``, which read the kernels' own arguments, on one set of the
port's seeded kernel tables built on the CPU; and the bounds of the
cells' own shapes."""

import sys
from pathlib import Path

import pytest

from benchmark.roofline import bounds

pytest.importorskip("romtime_tpu_torch")
sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
import chip_smoke  # noqa: E402
from romtime_tpu_torch.testing import synthetic  # noqa: E402


@pytest.mark.parametrize("N, W, width, B", [(12, 3, 4, 16), (32, 2, 5, 8),
                                            (40, 2, 3, 8)])
def test_k1_bound_matches_chip_smoke(N, W, width, B):
    args, kw = synthetic.kernel_tables(N, W, width, B, device="cpu")
    ms, what = chip_smoke.k1_bound(args, kw)
    km = chip_smoke.live_rows(args[1][:, :kw["km8"]].transpose(1, 2),
                              args[6].shape[2], N)
    kk = chip_smoke.live_rows(
        args[1][:, kw["km8"]:kw["km8"] + kw["kk8"]].transpose(1, 2),
        args[6].shape[2], N)
    kf = chip_smoke.live_rows(args[4].transpose(1, 2), args[6].shape[2], N)
    p = chip_smoke.probe_rows(args[6], N)
    s, mine = bounds.k1_seconds(W * width, W, N, B, km, kk, kf, p)
    assert mine == what
    assert s * 1e3 == pytest.approx(ms, rel=1e-12)


@pytest.mark.parametrize("N, nt, B", [(15, 20, 16), (9, 12, 8)])
def test_k4_bound_matches_chip_smoke(N, nt, B):
    args, kw = synthetic.global_tables(N, nt, B, device="cpu")
    ms, what = chip_smoke.k4_bound(args, kw)
    p = chip_smoke.probe_rows(args[5], N)
    s, mine = bounds.k4_seconds(nt, N, B, p)
    assert mine == what
    assert s * 1e3 == pytest.approx(ms, rel=1e-12)


def test_cell_bounds():
    """The fleet's two shapes and the global ROM at B=2048: K1 is bound by
    its operations, K4 by its bytes (the materialized tables)."""
    s32, w32 = bounds.k1_seconds(1500, 50, 32, 2048, 8, 24, 8, 2)
    s48, w48 = bounds.k1_seconds(1500, 150, 48, 2048, 8, 24, 8, 2)
    s15, w15 = bounds.k4_seconds(1500, 15, 2048, 2)
    assert (w32, w48, w15) == ("operations", "operations", "bytes")
    assert s48 > 2 * s32 > 0
    assert 1e-3 < s15 < 1e-2
