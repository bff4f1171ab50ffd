"""Compute-dtype control (counterpart of ``romtime_tpu/dtypes.py``).

Serving runs in ``torch.float32`` (the dd-carried kernel recursion);
checks switch to ``torch.float64`` with :func:`compute_dtype_scope`::

    with compute_dtype_scope(torch.float64):
        prepped = prep(...)
"""

from contextlib import contextmanager

import torch

_COMPUTE_DTYPE = torch.float32


def compute_dtype():
    return _COMPUTE_DTYPE


@contextmanager
def compute_dtype_scope(dtype):
    global _COMPUTE_DTYPE
    previous = _COMPUTE_DTYPE
    _COMPUTE_DTYPE = dtype
    try:
        yield
    finally:
        _COMPUTE_DTYPE = previous


@contextmanager
def full_f32_matmul():
    """TF32 off and the float32 matmul precision at "highest" inside the
    block, restored after: the FOM sweeps contract in full float32, as
    the reference pins ``jax.default_matmul_precision("highest")``."""
    previous = (torch.backends.cuda.matmul.allow_tf32,
                torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(previous[1])
        torch.backends.cuda.matmul.allow_tf32 = previous[0]


def require_full_f32_matmul():
    """Raise unless float32 contractions run at full precision (TF32
    would inject ~1e-3 relative noise into the assembled bands)."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "the FOM sweep needs full float32 contractions: TF32 is on "
            "(run it inside dtypes.full_f32_matmul())")


def asarray(x, device=None):
    """Tensor in the active compute dtype."""
    return torch.as_tensor(x, dtype=compute_dtype(), device=device)
