"""Mesh construction.

Counterpart of the JAX package's `launch/mesh.py`: functions, not module
constants, so importing this module touches no device and starts no
process group.  `dist_config` is the reference's.  A `mesh_shape` holds
axis names and sizes only, for the spec arithmetic of the dry run (no
devices); `make_smoke_mesh` and `make_production_mesh` build
`torch.distributed` `DeviceMesh`es.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..device import resolve_device
from ..distributed.sharding import DistConfig

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Axis names and sizes of a mesh without devices."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    @property
    def name(self) -> str:
        return "x".join(str(s) for s in self.sizes)


def mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    """The production mesh's axes and sizes: 16x16 (data, model) or
    2x16x16 (pod, data, model)."""
    sizes, axes = PRODUCTION[multi_pod]
    return MeshShape(axes, sizes)


def dist_config(*, multi_pod: bool = False, fsdp: bool = True,
                fsdp_over_pod: bool = False, parallel_mode: str = "tp",
                kv_seq_shard: bool = False) -> DistConfig:
    return DistConfig(pod_axis="pod" if multi_pod else None, fsdp=fsdp,
                      fsdp_over_pod=fsdp_over_pod,
                      parallel_mode=parallel_mode, kv_seq_shard=kv_seq_shard)


def make_smoke_mesh(device="cuda"):
    """A (1, 1) ("data", "model") DeviceMesh on one device, over a process
    group of world size 1 (gloo on the CPU, NCCL on the card) made from an
    in-process `HashStore`, so concurrent processes never share a port.
    Starts the default process group if none is running; raises if one of
    another world size is."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    elif dist.get_world_size() != 1:
        raise RuntimeError(f"make_smoke_mesh needs world size 1, the "
                           f"running group has {dist.get_world_size()}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return init_device_mesh(dev.type, (1, 1),
                            mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The 16x16 (256 devices) or 2x16x16 (512 devices) DeviceMesh over the
    running default process group.  Raises if there is none or its world
    size is not the mesh's: it never builds a smaller mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = mesh_shape(multi_pod=multi_pod)
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != shape.size:
        raise RuntimeError(
            f"the {shape.name} mesh needs a process group of world size "
            f"{shape.size}; the running one has "
            f"{'none' if world is None else world}")
    return init_device_mesh(resolve_device(device).type, shape.sizes,
                            mesh_dim_names=shape.axis_names)
