"""Parameter specs: one tree of `ParamSpec` (shape, logical axes, init,
dtype) per model, from which the random parameters are drawn.

The init rules are the reference's: "normal" draws N(0, 1) in float32,
multiplies by `scale` (default 1/sqrt(fan_in), where fan_in is the first
dimension of a matrix and the length of a vector) and casts to the spec's
dtype; "zeros" and "ones" fill. A stacked leaf (leading `stack` axis) takes
its fan-in from that axis, as the reference's does. The draws come from a
`torch.Generator`, so they are not the reference's numbers: tests carry
the reference's parameters across with `repro_torch.convert`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.mesh_utils import LogicalRules, local_shard, resolve_pspec


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis per dim
    init: str = "normal"  # normal | zeros | ones
    scale: Optional[float] = None  # None -> 1/sqrt(fan_in)
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def tree_leaves(tree) -> list:
    """Every leaf of a tree of dicts and lists (spec, tensor or array):
    dict keys in sorted order, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for sub in tree for x in tree_leaves(sub)]
    return [tree]


def tree_map(fn, tree):
    """The same tree of dicts and lists with `fn(leaf)` at every leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_map_with(fn, tree, other):
    """`tree_map` over two trees of the same structure: fn(leaf, its
    counterpart in `other`). `other` may hold tuples at its leaves (spec
    tuples): it is walked along `tree`'s dicts and lists only."""
    if isinstance(tree, dict):
        return {k: tree_map_with(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with(fn, v, o) for v, o in zip(tree, other, strict=True)]
    return fn(tree, other)


def local_params(params, specs, mesh):
    """This rank's shards of a tree of whole tensors under a spec tree of
    the same structure (`param_pspecs`' tuples, a tree's layout): the
    reference's `device_put` with a `NamedSharding` a leaf, as
    `mesh_utils.local_shard` copies. Meta tensors give meta shards of the
    local shapes. An LM's per-layer tree takes `transformer.lm_local_pspecs`."""
    return tree_map_with(lambda p, s: local_shard(p, s, mesh), params, specs)


def _draw(s: ParamSpec, generator: torch.Generator, device: torch.device) -> torch.Tensor:
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=s.dtype, device=device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=s.dtype, device=device)
    if s.init != "normal":
        raise ValueError(f"unknown init {s.init!r}")
    fan_in = s.shape[0] if len(s.shape) >= 2 else max(s.shape[-1], 1)
    scale = s.scale if s.scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(s.shape, generator=generator, dtype=torch.float32, device=device)
    return (x * scale).to(s.dtype)


def init_params(specs, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None):
    """Random parameters for a spec tree, drawn on `device` (CUDA unless the
    caller asks for the CPU) from `generator`, which must live on that
    device (default: a generator there seeded with 0)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return tree_map(lambda s: _draw(s, generator, dev), specs)


def abstract_params(specs):
    """The spec tree as `meta` tensors: shapes and dtypes, no memory."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), specs)


def param_pspecs(specs, lr: Optional[LogicalRules] = None):
    """The spec tree as sharding specs (`distributed.mesh_utils`)."""
    return tree_map(lambda s: resolve_pspec(s.axes, s.shape, lr), specs)


def param_count(specs) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(specs))


def param_bytes(specs) -> int:
    return sum(math.prod(s.shape) * s.dtype.itemsize for s in tree_leaves(specs))
