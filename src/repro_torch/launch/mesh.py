"""Meshes (the reference's ``launch/mesh.py``). Functions, not module
constants: importing this module touches no device and no process group."""
from __future__ import annotations

from typing import Optional, Sequence

from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import resolve_device
from repro_torch.parallel.sharding import MeshShape


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16x16 = 256 chips a pod; 2 pods = 512 chips with a ``pod`` axis. A
    description (names and sizes): it creates no devices."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def make_test_mesh(n_devices: int) -> MeshShape:
    """A ("data", "model") mesh over ``n_devices``: ``model`` is the first
    of 4, 2, 1 that divides the count, as the reference's."""
    model = next(m for m in (4, 2, 1) if n_devices % m == 0)
    return MeshShape((n_devices // model, model), ("data", "model"))


def make_device_mesh(shape: Sequence[int], names: Sequence[str], device: Optional[str] = None):
    """The DeviceMesh of ``shape`` over the ranks of the initialised process
    group (their product must be its world size), on the card unless
    ``device="cpu"``; raises without a card."""
    dev = resolve_device(device)
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(names))
