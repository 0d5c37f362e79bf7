"""A named mesh over the ranks of a torch.distributed process group.

The reference lays its devices out on a `jax.sharding.Mesh` with axes
("pod", "data", "model") and flattens every axis into one processor index
(`graph_serving._proc_axes`). Here each rank is one device: rank r sits at
the row-major coordinates of r over the mesh's axes, taken in the order
("pod", "data", "model"), so the processor index of a rank is the rank
itself. A collective over one axis runs on that axis's group: the ranks
that share every other coordinate, in ascending order, so a rank's index
in the group is its coordinate on the axis. A collective over a tuple of
axes runs on their flattened group: the ranks that share every other
coordinate, in ascending order, so a rank's index in it is its row-major
coordinate over those axes (data-major for ("data", "model"), as the
reference's device order: over every axis, the rank itself).

`init_mesh` starts the process group: NCCL for a CUDA device (after
`torch.cuda.set_device` on the local rank), gloo for the CPU, or the
backend the caller names (gloo with a CUDA device runs several ranks on one
card). It never falls back from one backend to the other.
"""

from __future__ import annotations

import itertools
import math
import os
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

AXES = ("pod", "data", "model")
AxisNames = Union[str, Sequence[str]]
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}  # the default backend of a device type


class ProcessMesh:
    """The mesh `shape` over `axes` on the initialised default process
    group, whose world size must equal the product of the shape. Every rank
    builds it with the same arguments: each rank creates every axis group,
    then every flattened group of two or more axes, in the same order, as
    `dist.new_group` requires."""

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
        subsets = [(a,) for a in axes] + [c for n in range(2, len(axes) + 1)
                                          for c in itertools.combinations(axes, n)]
        for sub in subsets:
            # one group per block of the mesh over `sub`, in row-major order
            dims = [axes.index(a) for a in sub]
            rest = [i for i in range(len(axes)) if i not in dims]
            blocks = coords.permute(rest + dims).reshape(-1, math.prod(shape[i] for i in dims))
            for ranks in blocks.tolist():
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    self._groups[sub] = group

    @staticmethod
    def _names(name: AxisNames) -> Tuple[str, ...]:
        return (name,) if isinstance(name, str) else tuple(name)

    def axis_size(self, name: AxisNames) -> int:
        """The size of axis `name`, or of a tuple of axes flattened."""
        return math.prod(self.shape[a] for a in self._names(name))

    def axis_index(self, name: AxisNames) -> int:
        """This rank's coordinate on axis `name`, or its row-major index over
        a tuple of axes (its index in their group)."""
        idx = 0
        for a in self._names(name):
            idx = idx * self.shape[a] + self._coords[a]
        return idx

    def group(self, name: Optional[AxisNames] = None):
        """The group of axis `name`, or of a tuple of axes flattened (in
        the mesh's axis order); None names every axis (the world)."""
        if name is None:
            return dist.group.WORLD
        names = self._names(name)
        if [a for a in self.axes if a in names] != list(names):
            raise ValueError(f"axes {names}: a subsequence of the mesh's {self.axes}")
        return self._groups[names]


def init_mesh(shape: Sequence[int], axes: Sequence[str], device: DeviceLike = None, *,
              backend: Optional[str] = None, store: Optional[dist.Store] = None,
              rank: Optional[int] = None,
              world_size: Optional[int] = None) -> Tuple[ProcessMesh, torch.device]:
    """Start the default process group and build the mesh on it.

    Rank and world size come from the arguments, else from `RANK` /
    `WORLD_SIZE` (as torchrun sets them, with `MASTER_ADDR` / `MASTER_PORT`
    for the rendezvous); with neither, the process is a world of one. The
    device is CUDA unless "cpu" is asked for, on `cuda:LOCAL_RANK`. The
    backend is NCCL for CUDA and gloo for the CPU unless `backend` names
    one: "gloo" with a CUDA device lets several ranks share one card, which
    NCCL refuses. Returns (mesh, this rank's device)."""
    dev = resolve_device(device)
    env = "RANK" in os.environ
    if rank is None:
        rank = int(os.environ["RANK"]) if env else 0
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"]) if env else 1
    if dev.type not in BACKENDS:
        raise ValueError(f"no process-group backend for device {dev}")
    backend = backend or BACKENDS[dev.type]
    if backend not in ("nccl", "gloo") or (backend == "nccl" and dev.type != "cuda"):
        raise ValueError(f"backend {backend!r} for device {dev}")
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", dev.index or 0)))
        torch.cuda.set_device(dev)
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
