"""Production mesh construction (``src/repro/launch/mesh.py``).

Functions, never module-level constants, so importing this module touches
no process group.  A ``DeviceMesh`` needs the default process group to
hold exactly the mesh's ranks: 256 for the single pod, 512 for the
multi-pod mesh, 1 for the host mesh.  :class:`AbstractMesh` carries only
names and sizes, enough for specs and shard shapes with no process group.
"""
from __future__ import annotations

from typing import Sequence

import torch

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


class AbstractMesh:
    """Axis names and sizes of a mesh, with the ``DeviceMesh`` accessors
    the rules read (``mesh_dim_names``, ``size(dim)``, ``ndim``)."""

    def __init__(self, shape: Sequence[int], names: Sequence[str]):
        self.shape = tuple(shape)
        self.mesh_dim_names = tuple(names)
        self.ndim = len(self.shape)

    def size(self, dim: int = None) -> int:
        if dim is None:
            n = 1
            for s in self.shape:
                n *= s
            return n
        return self.shape[dim]


def _device_type(device_type):
    if device_type is not None:
        return device_type
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """16x16 ("data", "model") single pod over 256 ranks, or 2x16x16
    ("pod", "data", "model") over 512.  The default process group must
    already hold that many ranks (a real cluster, or the fake group of
    the dry-run)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, names = MULTI_POD if multi_pod else SINGLE_POD
    need = 1
    for s in shape:
        need *= s
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != need:
        raise RuntimeError(
            f"the {'x'.join(map(str, shape))} production mesh requires "
            f"{need} ranks (>= 256 devices); this world has {have}")
    return init_device_mesh(_device_type(device_type), shape,
                            mesh_dim_names=names)


def make_host_mesh(device_type=None):
    """A 1x1 ("data", "model") mesh on the caller's device: a world of
    one (NCCL on the card, gloo on the CPU).  Initialises that world when
    no process group exists yet."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dt = _device_type(device_type)
    if not dist.is_initialized():
        _init_world_of_one(dt)
    return init_device_mesh(dt, (1, 1), mesh_dim_names=("data", "model"))


def _init_world_of_one(device_type: str) -> None:
    """The default process group of one rank, over a TCP store on a free
    local port."""
    import socket

    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
