"""The μ mesh (counterpart of ``romtime_tpu/parallel/mesh.py``).

One process drives every device of the mesh, as the reference's single
controller does: a sweep splits its μ batch into one contiguous shard
per mesh entry, launches each shard's work on that entry's device in
turn (launches are asynchronous, so the devices' work overlaps) and
gathers the shards once at the end. No ``torch.distributed`` process
group is involved.

A device may repeat in a mesh: ``DeviceMesh([torch.device("cpu")] * 8)``
runs eight shards in turn on one device, the port's analog of the
reference tests' eight virtual CPU devices. The caller states repeats;
:func:`device_mesh` never makes them up.
"""

import torch

MU_AXIS = "mu"


def _resolved(device):
    """``device`` as a ``torch.device`` with its index: a bare "cuda" is
    the current card, as a tensor placed there reports it; without a
    card that raises."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for a mesh entry 'cuda'")
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class DeviceMesh:
    """A 1-D mesh over the μ batch: ``devices``, a tuple of
    ``torch.device`` with their indices (repeats allowed), and ``size``,
    their count."""

    def __init__(self, devices):
        self.devices = tuple(_resolved(d) for d in devices)
        if not self.devices:
            raise ValueError("a device mesh needs at least one device")

    @property
    def size(self):
        return len(self.devices)

    def __repr__(self):
        return f"DeviceMesh({[str(d) for d in self.devices]})"


def device_mesh(n_devices=None, device_type="cuda"):
    """The mesh over the first ``n_devices`` distinct devices of
    ``device_type`` (all of them by default). Raises where there are
    fewer: it never falls back to another device type. The CPU counts as
    one device."""
    if device_type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(have)]
    elif device_type == "cpu":
        devices = [torch.device("cpu")]
    else:
        raise ValueError(f"unknown device type {device_type!r}")
    want = len(devices) if n_devices is None else int(n_devices)
    if want < 1 or want > len(devices):
        raise RuntimeError(
            f"device_mesh({n_devices}, {device_type!r}): {len(devices)} "
            f"{device_type} device(s) available")
    return DeviceMesh(devices[:want])


def mu_sharding(mesh, n):
    """The split of a μ batch of ``n`` (a multiple of ``mesh.size``):
    (device, slice) per shard, contiguous, in mesh order."""
    if n % mesh.size:
        raise ValueError(f"a batch of {n} does not split over "
                         f"{mesh.size} shards (pad it first)")
    per = n // mesh.size
    return [(d, slice(i * per, (i + 1) * per))
            for i, d in enumerate(mesh.devices)]


def replicated(mesh, tensor):
    """``tensor`` on every device of the mesh, one copy per distinct
    device (a repeated device shares its copy)."""
    copies = {}
    return [copies.setdefault(d, tensor.to(d)) for d in mesh.devices]
