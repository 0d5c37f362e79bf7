"""A named mesh over the ranks of a torch.distributed process group.

The reference lays its devices out on a `jax.sharding.Mesh` with axes
("pod", "data", "model") and flattens every axis into one processor index
(`graph_serving._proc_axes`). Here each rank is one device: rank r sits at
the row-major coordinates of r over the mesh's axes, taken in the order
("pod", "data", "model"), so the processor index of a rank is the rank
itself. A collective over one axis runs on that axis's group: the ranks
that share every other coordinate, in ascending order, so a rank's index
in the group is its coordinate on the axis.

`init_mesh` starts the process group: NCCL for a CUDA device (after
`torch.cuda.set_device` on the local rank), gloo for the CPU. It never
falls back from one backend to the other.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

AXES = ("pod", "data", "model")


class ProcessMesh:
    """The mesh `shape` over `axes` on the initialised default process
    group, whose world size must equal the product of the shape. Every rank
    builds it with the same arguments: each rank creates every axis group,
    in the same order, as `dist.new_group` requires."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes) or not axes:
            raise ValueError(f"mesh shape {shape} for axes {axes}")
        if [a for a in AXES if a in axes] != list(axes):
            raise ValueError(f"mesh axes {axes}: a subsequence of {AXES} in that order")
        if not dist.is_initialized():
            raise RuntimeError("ProcessMesh needs an initialised process group (init_mesh)")
        world = dist.get_world_size()
        if world != math.prod(shape):
            raise ValueError(f"world size {world} for a mesh of shape {shape}")
        self.shape: Dict[str, int] = dict(zip(axes, shape))
        self.axes = axes
        self.rank = dist.get_rank()
        coords = torch.tensor(range(world)).view(shape)
        self._coords = dict(zip(axes, (int(c) for c in (coords == self.rank).nonzero()[0])))
        self._groups = {}
        for i, axis in enumerate(axes):
            # one group per line of the mesh along `axis`, in row-major order
            lines = coords.movedim(i, -1).reshape(-1, shape[i]).tolist()
            for ranks in lines:
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    self._groups[axis] = group

    def axis_index(self, name: str) -> int:
        """This rank's coordinate on axis `name`."""
        return self._coords[name]

    def group(self, name: Optional[str] = None):
        """The group of axis `name`; None names every axis (the world)."""
        return dist.group.WORLD if name is None else self._groups[name]


def init_mesh(shape: Sequence[int], axes: Sequence[str], device: DeviceLike = None, *,
              store: Optional[dist.Store] = None, rank: Optional[int] = None,
              world_size: Optional[int] = None) -> Tuple[ProcessMesh, torch.device]:
    """Start the default process group and build the mesh on it.

    Rank and world size come from the arguments, else from `RANK` /
    `WORLD_SIZE` (as torchrun sets them, with `MASTER_ADDR` / `MASTER_PORT`
    for the rendezvous); with neither, the process is a world of one. The
    device is CUDA unless "cpu" is asked for: NCCL on `cuda:LOCAL_RANK`,
    gloo on the CPU. Returns (mesh, this rank's device)."""
    dev = resolve_device(device)
    env = "RANK" in os.environ
    if rank is None:
        rank = int(os.environ["RANK"]) if env else 0
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"]) if env else 1
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", dev.index or 0)))
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {dev}")
    if store is None and not env:
        if world_size != 1:
            raise ValueError(f"a world of {world_size} needs a store or torchrun's environment")
        store = dist.HashStore()
    if store is None:
        dist.init_process_group(backend, rank=rank, world_size=world_size)
    else:
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)
    return ProcessMesh(shape, axes), dev


def n_processors(mesh: ProcessMesh) -> int:
    """Every axis flattened: one query processor a rank."""
    return math.prod(mesh.shape.values())
