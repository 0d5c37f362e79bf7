"""Edge-index message passing primitives (segment-reduce based), the
reference's `models/gnn/message_passing.py`.

`aggregate` reaches the segment-sum kernel through `kernels.ops` unless
`use_kernel=False`, as the reference's reaches its Pallas kernel unless
`use_pallas=False`. `degree` and `segment_softmax` use plain segment
reductions, as the reference's call `jax.ops.segment_*` directly. `rows`
gathers node rows for edges, as the zoo's models do. `shard_graph_batch`
puts the reference's sharding constraints on a batch
(`distributed.mesh_utils.shard_constraint`: the spec resolved, the values
unchanged).
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.distributed.mesh_utils import shard_constraint
from repro_torch.kernels import ops, ref


def rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] along the first axis by `index_select`: its backward is an
    `index_add_` of the rows, where `x[idx]`'s (`index_put_` with
    accumulate) takes repeated ids one after another, and a node is read by
    each of its edges."""
    return torch.index_select(x, 0, idx)


def degree(dst: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) float32 in-degree: edges per destination; ids < 0 or >= n are
    not counted."""
    return ref.segment_sum_ref(torch.ones((dst.shape[0], 1), device=dst.device), dst, n)[:, 0]


def aggregate(messages: torch.Tensor, dst: torch.Tensor, n: int,
              kinds: Sequence[str] = ("sum",), use_kernel="auto") -> list:
    """Multi-aggregator segment reduce; returns one (n, D) tensor per kind
    of "sum", "mean", "max", "min", "std". "std" is
    sqrt(max(mean(m^2) - mean(m)^2, 0) + 1e-6). Differentiable on the plain
    path (`use_kernel=False`), with the reference's gradients at ties."""
    out = []
    for kind in kinds:
        if kind == "sum":
            out.append(ops.segment_sum(messages, dst, n, use_kernel=use_kernel))
        elif kind == "mean":
            out.append(ops.segment_mean(messages, dst, n, use_kernel=use_kernel))
        elif kind == "max":
            out.append(ops.segment_max(messages, dst, n))
        elif kind == "min":
            out.append(ops.segment_min(messages, dst, n))
        elif kind == "std":
            m1 = ops.segment_mean(messages, dst, n, use_kernel=use_kernel)
            m2 = ops.segment_mean(messages * messages, dst, n, use_kernel=use_kernel)
            # maximum, not clamp: at a tie (one message, or all equal) its
            # gradient is half, as jnp.maximum's
            var = m2 - m1 * m1
            out.append(torch.sqrt(torch.maximum(var, var.new_zeros(())) + 1e-6))
        else:
            raise ValueError(kind)
    return out


def segment_softmax(scores: torch.Tensor, dst: torch.Tensor, n: int) -> torch.Tensor:
    """Softmax over incoming edges per destination node: scores (E, H) ->
    (E, H). Edges with dst < 0 get 0. As in the reference, an edge with
    dst >= n is left out of every reduction but reads node n - 1's max and
    denominator (its gathers clamp)."""
    ok = (dst >= 0)[:, None]
    slot = ref.segment_slots(dst, n)[:, None].expand_as(scores)
    gather = dst.long().clamp(0, n - 1)
    neg = torch.full_like(scores, -torch.inf)
    smax = neg.new_full((n + 1, scores.shape[1]), -torch.inf).scatter_reduce_(
        0, slot, torch.where(ok, scores, neg), "amax")[:n]
    smax = torch.where(torch.isfinite(smax), smax, 0.0)
    ex = torch.where(ok, torch.exp(scores - rows(smax, gather)), 0.0)
    denom = ref.segment_sum_ref(ex, dst, n)
    return ex / torch.clamp(rows(denom, gather), min=1e-9)


def shard_graph_batch(batch: dict) -> dict:
    """Apply logical sharding constraints to a GNN batch: node arrays over
    "nodes", edge arrays over "edges"."""
    out = dict(batch)
    for k in ("node_feat", "node_pos"):
        if k in out:
            out[k] = shard_constraint(out[k], ("nodes", None))
    for k in ("src", "dst"):
        if k in out:
            out[k] = shard_constraint(out[k], ("edges",))
    return out
