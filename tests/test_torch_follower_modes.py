"""K1's paired-LU follower modes: the port's twin against the reference
kernel online_sweep_windowed_fused in interpret mode, on the reference's
own data recipe and limit (tests/test_pallas_online.py
test_windowed_fused_paired_lu_matches, :721-783): N=24 (blocked LU),
W=3 windows of width 8, θ damped to a ~0.5%-per-step drift and, for
warm1 and warmx, interpolated linearly in time; probes and state within
5e-5·scale.

G ∈ {3, 5} at width 8 ≥ G+2, so every case runs at least one follower
(the reference's G=10 and G=14 cases at width 8 run none). The CUDA
kernel is held against the twin on the card (tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romtime_tpu.ops.pallas_online import (
    _chunk_capped,
    online_sweep_windowed_fused as ref_sweep,
)
from romtime_tpu_torch.ops import windowed_fused as k1
from test_torch_windowed_fused import WIDTH, _tables

FOLLOWER_MODES = ("warm1", "warm2", "warmx", "inv1", "inv2")


def _follower_tables(mode):
    args, kw = _tables(24, seed=13, smooth=True)
    if mode in ("warm1", "warmx"):
        TH = args[0]
        rows = kw["km8"] + kw["kk8"] + kw["kf8"]
        t = np.linspace(0.0, 1.0, TH.shape[0])[:, None, None]
        TH[:, :rows] = (TH[:1, :rows] * (1 - t)
                        + TH[-1:, :rows] * t).astype(np.float32)
    return args, kw


@pytest.mark.parametrize("group", [3, 5])
@pytest.mark.parametrize("mode", FOLLOWER_MODES)
def test_twin_follower_mode_matches_reference_kernel(mode, group):
    period = _chunk_capped(WIDTH, 8)
    roles = k1.step_roles(period, group)
    assert roles.count("follow") >= 1, roles
    args, kw = _follower_tables(mode)
    ref_p, ref_s = ref_sweep(*[jnp.asarray(a) for a in args], **kw,
                             interpret=True, paired_lu=group,
                             paired_mode=mode)
    ref_p, ref_s = np.asarray(ref_p), np.asarray(ref_s)
    assert np.isfinite(ref_p).all() and np.isfinite(ref_s).all()
    got_p, got_s = k1.online_sweep_windowed_fused(
        *[torch.from_numpy(a) for a in args], **kw, paired_lu=group,
        paired_mode=mode, period=period)
    got_p, got_s = got_p.numpy(), got_s.numpy()
    scale = max(np.abs(ref_p).max(), 1e-6)
    np.testing.assert_allclose(got_p, ref_p, rtol=0, atol=5e-5 * scale)
    sscale = np.abs(ref_s[[0, 2]]).max()
    np.testing.assert_allclose(got_s[[0, 2]], ref_s[[0, 2]], rtol=0,
                               atol=5e-5 * sscale)
