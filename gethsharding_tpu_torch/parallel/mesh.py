"""The shard mesh: the port's counterpart of the JAX package's
`parallel/mesh.py`.

One logical axis, ``"shard"``, carries the framework's only data-parallel
dimension (the shard chains, `sharding_manager.sol:56`). Batch work whose
leading axis is the shard id splits into contiguous equal slabs, one per
mesh slot; the per-period cross-shard totals are the only values that
cross slots, as one reduction per mesh axis (`hierarchical_psum`).

The mesh lives in one process, as the reference's does (its `shard_map`
runs under one `jit` in the node's own backend): a `Mesh` is an ordered
tuple of `torch.device` slots. The slots are distinct CUDA cards where the
machine has them, or one device repeated (``["cuda:0"] * 4``,
``["cpu"] * 8``), the counterpart of the reference's virtual CPU devices.
Each slot's kernels launch on that slot's card and its current stream
(`slot_context`).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

import torch


class Mesh:
    """Slots in row-major order over `axis_names`: ``("shard",)``, or
    ``("dcn", "ici")`` (hosts × local cards). `reductions` counts the
    cross-slot reductions made over it (`hierarchical_psum`)."""

    def __init__(self, devices: Sequence, axis_names=("shard",),
                 shape: Optional[Sequence[int]] = None):
        self.devices = tuple(slot_device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        sizes = tuple(shape) if shape is not None else (len(self.devices),)
        if len(sizes) != len(self.axis_names):
            raise ValueError(f"mesh shape {sizes} for axes {self.axis_names}")
        n = 1
        for s in sizes:
            n *= s
        if n != len(self.devices) or n == 0:
            raise ValueError(f"mesh shape {sizes} over {len(self.devices)} "
                             "devices")
        self.shape = dict(zip(self.axis_names, sizes))
        self.reductions = 0
        self._lock = threading.Lock()

    @property
    def size(self) -> int:
        return len(self.devices)


def slot_device(device) -> torch.device:
    """A slot's device with its index: a bare ``"cuda"`` is the current
    card, so that caches keyed by device never mix two cards."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def visible_devices() -> list:
    """The distinct CUDA cards of this process, in index order."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over the ``"shard"`` axis: the first `n_devices` of
    `devices` (default: every visible card; None takes them all). An
    explicit `devices` list may repeat a device."""
    if devices is None:
        devices = visible_devices()
    devices = list(devices)
    want = len(devices) if n_devices is None else int(n_devices)
    if want < 1 or want > len(devices):
        raise ValueError(
            f"requested {max(want, 1)} devices, only {len(devices)} visible")
    return Mesh(devices[:want], axis_names=("shard",))


def make_multihost_mesh(n_hosts: Optional[int] = None,
                        devices_per_host: Optional[int] = None,
                        devices: Optional[Sequence] = None) -> Mesh:
    """A 2-D ``("dcn", "ici")`` mesh: hosts × local slots, the reference's
    factorization. In one process every slot is on host 0 (the reference
    groups by process index, then device id); the slots are ordered by
    (type, index), stably, and `n_hosts` (default 1) factors them."""
    if devices is None:
        devices = visible_devices()
    devices = sorted((slot_device(d) for d in devices),
                     key=lambda d: (d.type, d.index or 0))
    if n_hosts is None:
        n_hosts = 1
    if devices_per_host is None:
        if len(devices) % n_hosts:
            raise ValueError(
                f"{len(devices)} devices do not factor over {n_hosts} hosts")
        devices_per_host = len(devices) // n_hosts
    need = n_hosts * devices_per_host
    if need > len(devices) or need < 1:
        raise ValueError(
            f"requested {n_hosts}x{devices_per_host} devices, only "
            f"{len(devices)} visible")
    return Mesh(devices[:need], axis_names=("dcn", "ici"),
                shape=(n_hosts, devices_per_host))


def slot_context(device):
    """Run a slot's launches on its card: the kernels launch on the
    current card's current stream (`ops/_build.py`)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def split_rows(x: torch.Tensor, mesh: Mesh) -> list:
    """The counterpart of `shard_axis_sharding`: the leading axis in
    contiguous equal slabs, slab i on slot i's device (a view where the
    tensor is there already)."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split over {mesh.size} slots")
    r = n // mesh.size
    return [x[i * r:(i + 1) * r].to(dev, non_blocking=True)
            for i, dev in enumerate(mesh.devices)]


def pad_rows(x: torch.Tensor, pad: int) -> torch.Tensor:
    """`x` with `pad` zero rows appended along the leading axis."""
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def gather_rows(per_slot: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-slot slabs joined along the leading axis on slot 0's device."""
    dev = per_slot[0].device
    return torch.cat([t.to(dev, non_blocking=True) for t in per_slot])


def _reduce(group: list) -> torch.Tensor:
    """One group's sum on its first member's device."""
    if len(group) == 1:
        return group[0]
    if group[0].is_cuda:
        from torch.cuda import comm

        # NCCL's reduce between distinct cards; where a card repeats,
        # reduce_add copies and adds
        return comm.reduce_add(group, destination=group[0].device)
    out = group[0].clone()
    for t in group[1:]:
        out += t.to(out.device)
    return out


def hierarchical_psum(per_slot: Sequence[torch.Tensor], mesh: Mesh):
    """Sum the slots' partial totals over every mesh axis, innermost
    (``"ici"``) first, onto slot 0's device: a 2-D mesh reduces each
    host's slots, then the hosts' sums. Counts one reduction per axis
    in `mesh.reductions`."""
    if len(per_slot) != mesh.size:
        raise ValueError(f"{len(per_slot)} partial totals for "
                         f"{mesh.size} slots")
    values = [t.contiguous() for t in per_slot]
    for name in reversed(mesh.axis_names):
        k = mesh.shape[name]
        values = [_reduce(values[i:i + k]) for i in range(0, len(values), k)]
        with mesh._lock:
            mesh.reductions += 1
    return values[0]
