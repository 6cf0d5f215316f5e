"""Device placement: one device, or the shard mesh when asked (the port's
copy of the JAX package's `sigbackend/layout.py`).

One resolved `DeviceLayout` per backend decides where every plane lands.
The default is the single-device layout. With ``mesh_devices`` or
``GETHSHARDING_TORCH_MESH_DEVICES`` above 1 (or an explicit list of slots)
the layout is a 1-D ``("shard",)`` mesh (`parallel/mesh.py`): every batch
plane splits along its leading axis into contiguous equal slabs, one per
slot, and a slot's kernels run on its slab alone.

The reference's `count_collectives` and `count_ops` read XLA's optimized
HLO, and its `get_shard_map` wraps JAX; the port has neither. Their
counterparts are the mesh's reduction counter (`Mesh.reductions`, one
per axis a cross-slot sum reduces over) and the kernels' launch counts
(`ops/_build.py::launch_counts`).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from gethsharding_tpu_torch.device import resolve_device
from gethsharding_tpu_torch.parallel import mesh as mesh_mod
from gethsharding_tpu_torch.sigbackend.marshal import bucket_size

MESH_ENV = "GETHSHARDING_TORCH_MESH_DEVICES"


def mesh_devices_requested(explicit: Optional[int] = None) -> int:
    """The slot count to lay out over: an explicit argument wins, else
    ``GETHSHARDING_TORCH_MESH_DEVICES``, else 1 (one device)."""
    if explicit is not None:
        return max(1, int(explicit))
    raw = os.environ.get(MESH_ENV, "").strip()
    return max(1, int(raw)) if raw else 1


def resolve_slots(device=None, mesh_devices=None):
    """Where a `torch` backend runs: one device, or its mesh's slots as a
    list. A list of two or more devices is taken as it is; else
    `mesh_devices` (None: the knob) above 1 takes that many distinct cards
    (`device` None, raising where fewer are visible) or repeats
    `device`."""
    if isinstance(device, (list, tuple)):
        if len(device) > 1:
            return [mesh_mod.slot_device(d) for d in device]
        device = device[0]
    n = mesh_devices_requested(mesh_devices)
    if n == 1:
        return resolve_device(device)
    if device is None:
        return list(mesh_mod.make_mesh(n).devices)
    return [mesh_mod.slot_device(device)] * n


class DeviceLayout:
    """Resolved placement for one backend: `devices`, two or more slots
    (a device may repeat), or else `n_devices` above 1, the first that
    many distinct cards (`make_mesh`, which raises where there are
    fewer); one slot is no mesh."""

    def __init__(self, n_devices: int = 1, devices: Optional[Sequence] = None):
        self.mesh = None
        if devices is not None and len(devices) > 1:
            self.mesh = mesh_mod.make_mesh(devices=devices)
        elif devices is None and n_devices > 1:
            self.mesh = mesh_mod.make_mesh(n_devices)
        self.devices: tuple = self.mesh.devices if self.mesh else ()
        self.n_devices = self.mesh.size if self.mesh else 1

    @property
    def is_mesh(self) -> bool:
        return self.mesh is not None

    def mesh_bucket(self, n: int) -> int:
        """`bucket_size`, rounded up to a multiple of the slot count so
        the split is even (padded rows are masked rejections, as on one
        device)."""
        bucket = bucket_size(n)
        d = self.n_devices
        return -(-bucket // d) * d

    def rows_per_device(self, bucket: int) -> int:
        return bucket // self.n_devices

    def device_of_row(self, row: int, bucket: int) -> int:
        """The slot a (padded) batch row lands on under the contiguous
        split: the cache's sharding function."""
        return min(row // self.rows_per_device(bucket), self.n_devices - 1)

    def place(self, host_array) -> list:
        """One host plane split along its leading axis: slab i on slot
        i's device (each slot receives only its slab's bytes)."""
        host = np.ascontiguousarray(host_array)
        r = self.rows_per_device(host.shape[0])
        if r * self.n_devices != host.shape[0]:
            raise ValueError(f"{host.shape[0]} rows do not split over "
                             f"{self.n_devices} slots")
        return [torch.as_tensor(host[i * r:(i + 1) * r], device=dev)
                for i, dev in enumerate(self.devices)]

    def assemble(self, per_device: Sequence[torch.Tensor]) -> torch.Tensor:
        """Per-slot outputs joined along the leading axis, on slot 0."""
        return mesh_mod.gather_rows(per_device)
