"""K1 on the card against its plain PyTorch twin on the card. Needs a
CUDA device and nvcc; skips without a device. Imports no JAX, so it runs
on a machine without it (tests/conftest.py imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from romtime_tpu_torch.ops import windowed_fused as k1
from romtime_tpu_torch.testing.synthetic import kernel_tables

#: (N, W, width, B, paired-LU group, options): Gauss-Jordan-sized and
#: blocked-LU sizes, a ragged lane tile (B not a multiple of the tile),
#: grouping, no trilinear term, BDF-1.
CASES = [(12, 3, 8, 128, None, {}), (24, 3, 8, 130, None, {}),
         (24, 3, 8, 128, 5, {}), (32, 2, 30, 67, 5, {}),
         (48, 2, 10, 40, 5, {}), (24, 3, 8, 64, 5, {"with_trilinear": False}),
         (16, 2, 8, 64, None, {"bdf2": False})]


@pytest.mark.cuda
@pytest.mark.parametrize("N,W,width,B,group,options", CASES)
def test_cuda_kernel_matches_twin(N, W, width, B, group, options):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args, kw = kernel_tables(N, W, width, B, seed=N, device="cuda",
                             **options)
    kw.update(paired_lu=group)
    twin_p, twin_s = k1.windowed_fused_reference(*args, **kw)
    n0 = k1.online_sweep_windowed_fused.launches
    got_p, got_s = k1.online_sweep_windowed_fused(*args, **kw)
    torch.cuda.synchronize()
    assert k1.online_sweep_windowed_fused.launches == n0 + 1
    assert torch.isfinite(got_p).all() and torch.isfinite(got_s).all()
    scale = twin_p.abs().max().item()
    assert (got_p - twin_p).abs().max().item() <= 5e-5 * scale
    sscale = twin_s[[0, 2]].abs().max().item()
    assert (got_s - twin_s)[[0, 2]].abs().max().item() <= 5e-5 * sscale
