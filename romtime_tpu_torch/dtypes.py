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


def asarray(x, device=None):
    """Tensor in the active compute dtype."""
    return torch.as_tensor(x, dtype=compute_dtype(), device=device)
