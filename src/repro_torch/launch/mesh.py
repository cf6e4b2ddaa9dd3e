"""Device meshes over ``torch.distributed`` process groups (the JAX
package's ``launch/mesh.py``): the production meshes, single-pod 16x16 and
2-pod 2x16x16, and small meshes over whatever ranks exist.

Functions, not module constants, so that importing this module never
touches a device or a process group.  Nothing on a machine announces a
cluster: the caller starts the process group (address, world size, rank)
before asking for a mesh of more than one rank.
"""
from __future__ import annotations

from typing import Union

import torch
import torch.distributed as dist

from .. import _device


def _ensure_single_rank_group(dev: torch.device) -> None:
    """Start a world-size-1 process group (NCCL on a card, gloo on the
    CPU) when none exists; an in-memory store, so no port is opened."""
    if dist.is_initialized():
        return
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_host_mesh(data: int = 1, model: int = 1,
                   device: Union[str, torch.device] = "cuda"):
    """A ("data", "model") DeviceMesh over the current process group.

    With no group and ``data * model == 1`` it starts a world-size-1 group
    first; otherwise the group must exist and hold ``data * model``
    ranks.  Raises when a CUDA device is asked for and there is none."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = _device.resolve(device)
    if not dist.is_initialized():
        if data * model != 1:
            raise RuntimeError(
                f"a {data}x{model} mesh needs a process group of "
                f"{data * model} ranks: call "
                "torch.distributed.init_process_group first")
        _ensure_single_rank_group(dev)
    world = dist.get_world_size()
    if world != data * model:
        raise RuntimeError(f"a {data}x{model} mesh needs {data * model} "
                           f"ranks, the process group has {world}")
    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False,
                         device: Union[str, torch.device] = "cuda"):
    """The (16, 16) ("data", "model") mesh, or with ``multi_pod`` the
    (2, 16, 16) ("pod", "data", "model") one, over the default process
    group, which must hold 256 / 512 ranks (on one host, a fake group:
    ``launch.dryrun``)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 512 if multi_pod else 256
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != need:
        raise RuntimeError(f"the {'x'.join(map(str, shape))} production "
                           f"mesh needs a process group of {need} ranks, "
                           f"found {world or 'none'}")
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=axes)
