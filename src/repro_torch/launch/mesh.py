"""Production mesh shapes (the reference's `launch/mesh.py`), read as H100s.

A `MeshShape` names axes and their sizes and nothing else: the dry run
(`launch/dryrun.py`) resolves sharding specs and splits a step's counts
over it without touching a device, so any machine can plan for a mesh of
256 or 512 cards. Importing this module touches no device state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class MeshShape:
    axes: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axes) != len(self.sizes):
            raise ValueError(f"mesh axes {self.axes} and sizes {self.sizes} differ in length")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axes, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def name(self) -> str:
        return "x".join(map(str, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16x16 (256 H100s) or 2x16x16 (2 pods, 512 H100s).

    Axes: "pod" = inter-pod data parallelism (the slower links between
    nodes), "data" = in-pod data/FSDP axis, "model" = tensor/expert/storage
    axis."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_host_mesh(model: int = 1) -> MeshShape:
    """The port's world, model axis last: the ranks of the initialised
    process group, or one process when there is none."""
    import torch.distributed as dist

    n = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if n % model:
        raise ValueError(f"world of {n} does not split into model axis {model}")
    return MeshShape(("data", "model"), (n // model, model))
