"""Logical-axis sharding rules (the reference's `distributed/mesh_utils.py`).

Tensors are annotated with *logical* axis names; a rules table maps logical
names to mesh axes. Resolution enforces divisibility: if a dimension is not
divisible by the mapped mesh-axis size, the mapping falls back to a shorter
prefix of the mesh axes, then to replication for that dimension (so the
dry run can see what failed to shard -- e.g. qwen2.5's 40 q-heads on a
16-way model axis).

A mesh here is anything with a `shape` mapping axis name -> size (the
port's `ProcessMesh`, `launch.mesh.MeshShape`) or such a mapping itself.
A spec is a plain tuple with `PartitionSpec`'s entries, one per dimension:
None (replicated), an axis name, or a tuple of axis names.

Rules used by the assigned archs:

  batch   -> ("pod", "data")     data parallel (+ pod axis across pods)
  fsdp    -> "data"              parameter/optimizer sharding (ZeRO-3-ish)
  vocab   -> "model"
  embed   -> None                activations replicated on the model axis
  heads   -> "model"             tensor parallel attention
  kv_heads-> "model"
  mlp     -> "model"             tensor parallel FFN
  experts -> "model"             expert parallel
  seq     -> None                (context parallelism off in baseline)
  nodes   -> ("data", "model")   GNN full-graph row sharding
  edges   -> ("data", "model")
  storage -> "model"             gRouting storage shards / recsys vocab rows
  proc    -> "data"              gRouting query processors

`shard_constraint` is the reference's sharding constraint on an activation:
it resolves the spec (so a spec that does not fit raises) and returns the
tensor unchanged, since the reference's constraint changes a layout, never
a value, and the port's sharded code slices explicitly. `local_shard` is a
shard_map `in_spec`'s counterpart: a rank's block of a global tensor.
`layout` reads a resolved spec back (which dims split over which axes),
`gather` is `local_shard`'s inverse over some or all of those axes (a
tiled `collectives.all_gather` a dim, so its backward is a reduce-scatter:
FSDP's weight gather), and `split_axes` names every axis a spec splits.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple, Union

import torch

AxisName = Union[str, Tuple[str, ...], None]
Spec = Tuple[AxisName, ...]

DEFAULT_RULES: Dict[str, AxisName] = {
    "batch": ("pod", "data"),
    "fsdp": "data",
    "vocab": "model",
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "expert_capacity": None,
    "seq": None,
    "kv_seq": None,
    "nodes": ("data", "model"),
    "edges": ("data", "model"),
    "feat": None,
    "storage": "model",
    "proc": "data",
    "stack": None,  # stacked layer axis
}


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a mesh object with a `shape` mapping, or of the
    mapping itself."""
    shape = getattr(mesh, "shape", mesh)
    if not isinstance(shape, Mapping):
        raise TypeError(f"a mesh needs a shape mapping axis -> size, got {shape!r}")
    return {str(a): int(s) for a, s in shape.items()}


@dataclasses.dataclass
class LogicalRules:
    mesh: object
    rules: Dict[str, AxisName]

    @property
    def axes(self) -> Dict[str, int]:
        return mesh_axes(self.mesh)

    def mesh_axis_size(self, name: AxisName) -> int:
        if name is None:
            return 1
        names = (name,) if isinstance(name, str) else name
        return math.prod(self.axes.get(a, 1) for a in names)

    def _exists(self, name: AxisName) -> AxisName:
        """Drop mesh axes that don't exist in this mesh (e.g. 'pod' single-pod)."""
        if name is None:
            return None
        axes = self.axes
        if isinstance(name, str):
            return name if name in axes else None
        kept = tuple(a for a in name if a in axes)
        return kept if kept else None


_local = threading.local()


@contextlib.contextmanager
def set_mesh_rules(mesh, rules: Optional[Dict[str, AxisName]] = None):
    prev = getattr(_local, "rules", None)
    _local.rules = LogicalRules(mesh, dict(rules or DEFAULT_RULES))
    try:
        yield _local.rules
    finally:
        _local.rules = prev


def current_rules() -> Optional[LogicalRules]:
    return getattr(_local, "rules", None)


def resolve_pspec(logical_axes: Sequence[Optional[str]], shape: Sequence[int],
                  lr: Optional[LogicalRules] = None) -> Spec:
    """Logical axes + concrete shape -> spec tuple with divisibility fallback."""
    lr = lr or current_rules()
    if lr is None:
        return ()
    axes = lr.axes
    parts = []
    used: set = set()
    for dim, name in zip(shape, logical_axes):
        if name is None:
            parts.append(None)
            continue
        mapped = lr._exists(lr.rules.get(name))
        if mapped is None:
            parts.append(None)
            continue
        # a mesh axis may appear only once in a spec
        mapped_t = (mapped,) if isinstance(mapped, str) else mapped
        mapped_t = tuple(a for a in mapped_t if a not in used)
        if not mapped_t:
            parts.append(None)
            continue
        if dim % math.prod(axes[a] for a in mapped_t) != 0:
            # divisibility fallback: try progressively shorter prefixes
            ok = None
            for k in range(len(mapped_t) - 1, 0, -1):
                if dim % math.prod(axes[a] for a in mapped_t[:k]) == 0:
                    ok = mapped_t[:k]
                    break
            if ok is None:
                parts.append(None)
                continue
            mapped_t = ok
        used.update(mapped_t)
        parts.append(mapped_t if len(mapped_t) > 1 else mapped_t[0])
    return tuple(parts)


def shard_constraint(x, logical_axes: Sequence[Optional[str]]):
    """The reference's `with_sharding_constraint` by logical axes: x itself.
    Under rules the spec is resolved against x's shape first, and a spec
    longer than x's dims raises, as the reference's does."""
    lr = current_rules()
    if lr is None:
        return x
    if len(logical_axes) > len(x.shape):
        raise ValueError(f"a spec of {len(logical_axes)} axes for a tensor of shape "
                         f"{tuple(x.shape)}")
    resolve_pspec(logical_axes, x.shape, lr)
    return x


def local_shard(x, spec: Spec, mesh):
    """This rank's block of the global tensor x under `spec` (one entry a
    leading dim: None, an axis name or a tuple of axes) on a `ProcessMesh`:
    along each sharded dim, block `mesh.axis_index(entry)` of
    `mesh.axis_size(entry)` equal blocks. A copy, so the global tensor can
    be freed."""
    if len(spec) > x.dim():
        raise ValueError(f"a spec of {len(spec)} entries for a tensor of shape {tuple(x.shape)}")
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        n = mesh.axis_size(entry)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split {n} ways ({entry})")
        size = x.shape[dim] // n
        x = x.narrow(dim, mesh.axis_index(entry) * size, size)
    return x.clone(memory_format=torch.contiguous_format)


def shards(spec: Spec, mesh) -> int:
    """How many ways a tensor with this spec is split over the mesh (the
    product of the sizes of the axes its spec names)."""
    axes = mesh_axes(mesh)
    n = 1
    for entry in spec:
        for a in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
            n *= axes[a]
    return n


def _entry_axes(entry: AxisName) -> Tuple[str, ...]:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def layout(spec: Spec) -> Dict[int, Tuple[str, ...]]:
    """{dim: the axes it splits over, in the spec's order} of a resolved
    spec; a dim absent from it is whole on every rank."""
    return {dim: _entry_axes(e) for dim, e in enumerate(spec) if e is not None}


def split_axes(spec: Spec) -> Tuple[str, ...]:
    """Every mesh axis the spec splits some dim over, in the spec's order."""
    return tuple(a for axes in layout(spec).values() for a in axes)


def gather(x, spec: Spec, mesh, axes: Optional[Iterable[str]] = None):
    """`local_shard`'s inverse: this rank's block x of a tensor under `spec`,
    gathered to whole along every dim split over `axes` (default: every
    axis the spec names) by a tiled `collectives.all_gather` over that dim's
    group, whose backward is a reduce-scatter by sum. A dim split over a
    tuple of axes is gathered over their flattened group, so such an entry
    must lie within `axes` whole."""
    from repro_torch.distributed import collectives

    want = set(split_axes(spec) if axes is None else axes)
    for dim, names in layout(spec).items():
        hit = want.intersection(names)
        if not hit:
            continue
        if len(hit) != len(names):
            raise ValueError(f"dim {dim} splits over {names}: gather all of them or none")
        if mesh.axis_size(names) > 1:
            x = collectives.all_gather(x, mesh.group(names), dim)
    return x
