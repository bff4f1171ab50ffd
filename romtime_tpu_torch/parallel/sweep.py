"""Batched and sharded μ-sweeps (counterpart of
``romtime_tpu/parallel/sweep.py``).

``solve_fom_batch`` runs the FOM's time loop over a whole μ batch at
once on the solver's device, the batch trailing every band and state
inside the loop (``fom/base.py``). The sharded sweeps split the batch
over a :class:`~romtime_tpu_torch.parallel.mesh.DeviceMesh` (padded to a
multiple of its size by repeating the last μ), run each shard's batched
loop on the shard's device in turn, and gather the shards on the host
once all are launched; no collective is involved, as in the reference.
"""

import numpy as np
import torch

from ..dtypes import asarray, full_f32_matmul
from ..parameters import parameters_to_array
from .mesh import device_mesh, mu_sharding


def _mu_batch_dict(mus, names=None, device=None):
    """μ as name → (B,) tensors in the compute dtype on ``device``, from a
    dict of arrays or a list of μ dicts (columns in ``names`` order,
    default sorted)."""
    if isinstance(mus, dict):
        return {k: asarray(v, device) for k, v in mus.items()}
    arr, names = parameters_to_array(mus, names)
    return {name: asarray(arr[:, j], device) for j, name in enumerate(names)}


def _pad_batch(batch, multiple):
    """(batch padded to a multiple of ``multiple`` by repeating the last
    μ, the true batch size)."""
    n = next(iter(batch.values())).shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return batch, n
    return {k: torch.cat([v, v[-1:].expand(pad)]) for k, v in batch.items()}, n


def _run_sharded(mus, mesh, run):
    """``run(shard_batch)`` on each shard of the padded μ batch, its
    tensors on the shard's device: the shards are launched in turn, then
    every output is gathered to the host, concatenated along its
    ``axis`` (``run`` returns name → (tensor, axis)) and trimmed to the
    true batch."""
    if mesh is None:
        mesh = device_mesh()
    batch, n = _pad_batch(_mu_batch_dict(mus), mesh.size)
    padded = next(iter(batch.values())).shape[0]
    parts = [run({k: v[sl].to(dev) for k, v in batch.items()})
             for dev, sl in mu_sharding(mesh, padded)]
    out = {}
    for key, (_v, axis) in parts[0].items():
        host = np.concatenate([p[key][0].cpu().numpy() for p in parts],
                              axis=axis)
        out[key] = np.take(host, np.arange(n), axis=axis)
    return out


def solve_fom_batch(solver, mus, dilations=None):
    """The FOM sweep over a μ batch on the solver's device (the card
    unless it was built with ``device="cpu"``; without a card that raises).

    ``dilations`` (B,): each μ on its own grid, the final time T·d_b over
    the same nt steps (dt_b = d_b·dt), as a registered cell's training
    set is re-solved (the reference solves each such μ alone,
    ``rom/hrom.py:947-975``); the solver's T is restored after.

    Returns numpy arrays with the leading μ axis, as the reference's
    vmapped sweep: ``uh`` (B, nt, nh), ``uc``, ``x``, ``t`` (B, nt) and
    the solver's extras (``probes``, ``nonlinear_data``; ``uh_lo`` under
    ``dd_sweep``). Contractions run in full float32 (TF32 off): the
    reference pins ``jax.default_matmul_precision("highest")`` after a
    bf16 default took a served fleet from 2.5e-7 to 3.2e-5."""
    device = solver._compute_device()
    batch = _mu_batch_dict(mus, device=device)
    T = solver.domain[solver.T]
    if dilations is not None:
        solver.domain[solver.T] = float(T) * asarray(
            np.asarray(dilations, np.float64), device)
    try:
        with full_f32_matmul(), torch.no_grad():
            outs = solver._solve_impl(batch)
    finally:
        solver.domain[solver.T] = T
    return {k: v.cpu().numpy() for k, v in outs.items()}


def solve_fom_sharded(solver, mus, mesh=None):
    """The FOM sweep sharded over ``mesh``'s μ axis (default
    :func:`device_mesh`): each shard runs the batched time loop of
    :func:`solve_fom_batch` on its device, in full float32 (TF32 off).
    Same outputs as :func:`solve_fom_batch`, trimmed to the true batch;
    no ``dilations``, as in the reference."""
    def run(mu):
        outs = solver._solve_impl(mu)
        return {k: (v, 0) for k, v in outs.items()}

    with full_f32_matmul(), torch.no_grad():
        return _run_sharded(mus, mesh, run)


def solve_online_sharded(rom, mus, mesh=None, mode="reduced"):
    """The online ROM sweep sharded over ``mesh``'s μ axis: each shard
    runs the vmap engine (``rom._online_scan``, its operators and basis
    replicated on the shard's device) in the compute dtype. Returns
    batch-first numpy arrays, ``t`` (B, nt) as the reference's vmapped
    scan gives it."""
    rom._ensure_pivot_free_certified()

    def run(mu):
        outs = rom._online_scan(mu, mode=mode)
        B = next(iter(mu.values())).shape[0]
        return {k: ((v.expand(B, -1), 0) if k == "t" else (v, v.ndim - 1))
                for k, v in outs.items()}

    with torch.no_grad():
        outs = _run_sharded(mus, mesh, run)
    return {k: v if k == "t" else np.moveaxis(v, -1, 0)
            for k, v in outs.items()}


def solve_online_windowed_sharded(rom, mus, mesh=None, mode="probes"):
    """The windowed lanes engine (``engine="windowed"``) sharded over
    ``mesh``'s μ axis: each shard sweeps its μ on its device with the
    active windows' tables built for that device (cached on the windows
    object, so a μ-local cell swap brings that cell's own tables).
    Raises without windows and on unequal window widths, as the
    reference. Returns batch-first numpy arrays as ``solve_batch``;
    ``t`` is the shared (nt,) grid (arange(nt)+1)·dt."""
    from ..rom.engines.windowed_lanes import online_sweep_windowed

    win = rom.windows
    if win is None:
        raise ValueError("no windowed serving configuration attached "
                         "(build_windowed_serving first)")
    widths = sorted(set(np.diff(np.asarray(win.bounds)).tolist()))
    if len(widths) != 1:
        raise ValueError(f"sharded windowed serving needs equal window "
                         f"widths; got widths {widths}")
    rom._ensure_pivot_free_certified()
    sources = rom._theta_sources()

    def run(mu):
        dev = next(iter(mu.values())).device
        outs = online_sweep_windowed(rom.fom, win, sources,
                                     rom._lanes_tables(mode, dev), mu, mode)
        return {k: (v, v.ndim - 1) for k, v in outs.items() if k != "t"}

    with torch.no_grad():
        outs = _run_sharded(mus, mesh, run)
    outs = {k: np.moveaxis(v, -1, 0) for k, v in outs.items()}
    fom = rom.fom
    outs["t"] = (np.arange(int(fom.domain[fom.NT])) + 1) * float(fom.dt)
    return outs
