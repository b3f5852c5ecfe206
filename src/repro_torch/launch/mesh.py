"""Device meshes of the dry run (the reference is ``repro/launch/mesh.py``).

Functions, not module-level constants: importing this module touches no
device state and no process group.

The reference compiles its step for 256 or 512 TPU chips that do not
exist (``--xla_force_host_platform_device_count``). The port's
counterpart is a ``torch.distributed`` process group of that many ranks
in ONE process whose collectives do nothing (``fake_process_group``:
the backend ``"fake"`` of ``torch.testing._internal.distributed.fake_pg``),
and a ``DeviceMesh`` over it: DTensors on that mesh hold rank 0's local
shards and plan every redistribution as the real ranks would.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Tuple

import torch.distributed as dist


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes only (what the sharding rules read),
    for code that needs no process group."""
    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def production_shape(*, multi_pod: bool = False) -> MeshShape:
    """16x16 = 256 chips per pod; 2 pods = 512 chips multi-pod."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """The default process group, for the ``with`` block, is ``world_size``
    ranks in this process, this one rank 0, whose collectives return
    without moving data. Raises when a process group exists already."""
    if dist.is_initialized():
        raise RuntimeError("a torch.distributed process group is already "
                           "initialized; the dry run needs its own")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_over(shape: MeshShape, device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``shape`` over the default process group, whose
    size must be ``shape.size``."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if world != shape.size:
        raise ValueError(f"a {shape.shape} mesh needs {shape.size} ranks, the "
                         f"process group has {world}")
    return init_device_mesh(device_type, shape.shape,
                            mesh_dim_names=shape.mesh_dim_names)


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod", "data",
    "model"), over the default process group (in the dry run, a
    ``fake_process_group`` of 256 or 512 ranks)."""
    return mesh_over(production_shape(multi_pod=multi_pod))


def host_shape(n: int) -> MeshShape:
    """The reference's host mesh rule for ``n`` ranks: (n // 4, 4) from 8
    ranks up, else (1, n)."""
    if n >= 8:
        return MeshShape(("data", "model"), (n // 4, 4))
    return MeshShape(("data", "model"), (1, n))


def make_host_mesh(device="cuda"):
    """A ("data", "model") mesh over the ranks that exist, on ``device``'s
    type (the card unless the caller asks for the CPU; a CUDA device
    without CUDA raises): the default process group's ranks; without a
    process group, this process alone (a one-rank gloo group is made)."""
    from repro_torch.models import resolve_device
    dev = resolve_device(device).type
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    return mesh_over(host_shape(dist.get_world_size()), dev)
