"""Differentiable collectives over a process group: the port's counterpart
of the collectives the reference calls inside `shard_map` (`jax.lax.psum`,
`pmean`, `all_gather`, `all_to_all`). The reference has no file of its own
for them: `jax.lax` provides them, and shard_map's transposes give their
gradients. Each function here takes the group of a mesh axis or of a tuple
of axes (`ProcessMesh.group`).

The gradients are those shard_map gives the reference, under one rule: a
value that is the same on every rank of an axis has the same cotangent on
every rank of it (a loss read on every rank, a psum's result). So

  - `psum`: forward a sum over the group; backward the identity;
  - `enter`: forward the identity; backward a psum. Every input that the
    reference passes in replicated along an axis, and that then meets
    values that differ along it, enters the axis: each rank's cotangent
    holds only its own share;
  - `pmean`: forward the mean; backward the cotangent over the group size;
  - `invariant`: forward the identity; backward the cotangent over the
    group size. It marks a value computed alike on every rank from entered
    inputs, as shard_map divides the cotangent of an output over the axes
    its out_spec leaves out;
  - `all_gather` (tiled along a dim): backward a reduce-scatter by sum,
    built from `all_to_all` and a sum in rank order, which every backend
    takes;
  - `gather_invariant` (tiled along a dim): the gathered value is the
    same on every rank, so its cotangent is too, and each rank's backward
    is its own block of it (an activation split by column, gathered whole
    for a layer that every rank runs alike);
  - `all_to_all` (tiled along dim 0): backward the reverse exchange, which
    for equal blocks is the same exchange;
  - `pmax`: the max over the group, with no gradient (the vocab-parallel
    loss's shift, which cancels from its log-sum-exp).

PyTorch's own `torch.distributed.nn.functional` differs: its `all_reduce`
all-reduces the cotangent too, which behind a psum of the loss multiplies
gradients by the group size.

Backends: NCCL and gloo both take CUDA tensors for every call here (gloo
through its CUDA work on torch 2.11, checked on an H100), so no call
stages through host memory. gloo on torch 2.11 takes bf16 and float16
CUDA tensors as they are for all_reduce (sum and max), all_gather,
all_to_all_single and broadcast (checked on an H100), so a bf16 psum is
a sum in bf16 on every backend, as the reference's bf16 psum is, and no
gather moves bits in place of values. Integer tensors cross with no
gradient.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return dist.get_world_size(group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block s of x along dim 0 goes to the group's rank s; block s of the
    result came from it."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Scale(torch.autograd.Function):
    """Forward the identity (or `reduce`), backward g / n."""

    @staticmethod
    def forward(ctx, x, group, reduce):
        ctx.n = group_size(group)
        if reduce:
            return _all_reduce(x, group) / torch.full((), ctx.n, dtype=x.dtype, device=x.device)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / torch.full((), ctx.n, dtype=g.dtype, device=g.device), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(group_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        n = group_size(ctx.group)
        blocks = torch.stack(g.chunk(n, ctx.dim))  # block s: what rank s's shard fed
        return _all_to_all(blocks, ctx.group).sum(0), None, None


class _GatherInvariant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.size, ctx.rank = dim, x.shape[dim], dist.get_rank(group)
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(group_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group's ranks (`jax.lax.psum`); backward the identity."""
    return _Psum.apply(x, group)


def enter(x: torch.Tensor, group) -> torch.Tensor:
    """x, replicated along the group, as an input of the rank's share of
    the work; backward a psum of the cotangent."""
    return _Enter.apply(x, group)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """Mean over the group's ranks (`jax.lax.pmean`), a true division."""
    return _Scale.apply(x, group, True)


def invariant(x: torch.Tensor, group) -> torch.Tensor:
    """x, computed alike on every rank of the group, as one value: its
    cotangent is divided by the group size."""
    return _Scale.apply(x, group, False)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's shards concatenated along `dim` in rank order
    (`jax.lax.all_gather(..., tiled=True)`)."""
    return _AllGather.apply(x, group, dim)


def gather_invariant(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The group's shards concatenated along `dim` in rank order, as one
    value the same on every rank: backward this rank's block of the
    cotangent, which every rank holds whole."""
    return _GatherInvariant.apply(x, group, dim % x.dim())


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x (S, ...) with S the group size: row s goes to the group's rank s,
    row s of the result came from it (`jax.lax.all_to_all` tiled over axis
    0). Float payloads carry their gradient back to the senders."""
    return _AllToAll.apply(x, group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over the group's ranks, detached: no gradient
    flows through it (the caller uses it as a shift that cancels)."""
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out
