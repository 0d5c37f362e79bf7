"""Fanout neighbor sampler (GraphSAGE-style) for the minibatch_lg shape
(numpy; the port's copy of the reference's host sampler).

Given a seed batch, sample up to fanout[k] neighbors per node at hop k and
return a padded subgraph (edge index + node list) of static shape, so that
every training step sees the same tensor shapes. The arrays equal the
reference's for the same graph, fanout and seed.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.graph.csr import CSRGraph, sorted_unique


@dataclasses.dataclass
class SampledSubgraph:
    """Padded sampled subgraph of static shape.

    nodes:    (max_nodes,) int32 global node ids, -1 padded. nodes[:batch] are seeds.
    n_nodes:  valid count.
    src/dst:  (max_edges,) int32 *local* indices into `nodes`, -1 padded.
              Edges point from sampled neighbor (src) to the node that sampled
              it (dst): the message-passing direction.
    n_edges:  valid count.
    """

    nodes: np.ndarray
    n_nodes: int
    src: np.ndarray
    dst: np.ndarray
    n_edges: int

    @property
    def max_nodes(self) -> int:
        return int(self.nodes.shape[0])

    @property
    def max_edges(self) -> int:
        return int(self.src.shape[0])


def sampled_shape(batch_nodes: int, fanout: Sequence[int]) -> Tuple[int, int]:
    """Static (max_nodes, max_edges) for a fanout schedule."""
    nodes = batch_nodes
    total_nodes = batch_nodes
    total_edges = 0
    for f in fanout:
        edges = nodes * f
        total_edges += edges
        nodes = edges
        total_nodes += nodes
    return total_nodes, total_edges


class NeighborSampler:
    """Uniform fanout sampler over a host CSR graph."""

    def __init__(self, g: CSRGraph, fanout: Sequence[int], seed: int = 0):
        self.g = g
        self.fanout = list(fanout)
        self.rng = np.random.default_rng(seed)
        self._deg = np.diff(g.indptr)

    def _sample_neighbors(self, frontier: np.ndarray, f: int) -> Tuple[np.ndarray, np.ndarray]:
        """For each node in frontier, sample f neighbors with replacement
        (none when its degree is 0). Returns (src=sampled neighbor,
        dst=frontier node) pairs."""
        deg = self._deg[frontier]
        offs = self.rng.integers(0, np.maximum(deg, 1)[:, None], size=(frontier.size, f))
        base = self.g.indptr[frontier][:, None]
        nbrs = self.g.indices[base + offs]  # (n, f)
        valid = (deg > 0)[:, None] & np.ones((1, f), bool)
        dst = np.broadcast_to(frontier[:, None], (frontier.size, f))
        return nbrs[valid].astype(np.int64), dst[valid].astype(np.int64)

    def sample(self, seeds: np.ndarray) -> SampledSubgraph:
        seeds = np.asarray(seeds, dtype=np.int64)
        max_nodes, max_edges = sampled_shape(seeds.size, self.fanout)
        all_src: List[np.ndarray] = []
        all_dst: List[np.ndarray] = []
        frontier = seeds
        node_list = [seeds]
        for f in self.fanout:
            s, d = self._sample_neighbors(frontier, f)
            all_src.append(s)
            all_dst.append(d)
            frontier = sorted_unique(s)
            node_list.append(frontier)
        # local ids: unique nodes in order of first appearance (seeds first)
        cat = np.concatenate(node_list)
        uniq, first_idx = sorted_unique(cat, return_index=True)
        order = np.argsort(first_idx, kind="stable")
        nodes = uniq[order]
        if not np.array_equal(nodes[: seeds.size], seeds):
            raise ValueError("seeds must be distinct")
        # global -> local: uniq is sorted and holds every endpoint, and
        # uniq[k] has local id rank[k] (the reference's dict lookup, vectorized)
        rank = np.empty(order.size, np.int64)
        rank[order] = np.arange(order.size)
        src = np.concatenate(all_src) if all_src else np.zeros(0, np.int64)
        dst = np.concatenate(all_dst) if all_dst else np.zeros(0, np.int64)
        src_l = rank[np.searchsorted(uniq, src)]
        dst_l = rank[np.searchsorted(uniq, dst)]

        out_nodes = np.full(max_nodes, -1, np.int32)
        out_nodes[: nodes.size] = nodes
        out_src = np.full(max_edges, -1, np.int32)
        out_dst = np.full(max_edges, -1, np.int32)
        out_src[: src_l.size] = src_l
        out_dst[: dst_l.size] = dst_l
        return SampledSubgraph(
            nodes=out_nodes,
            n_nodes=int(nodes.size),
            src=out_src,
            dst=out_dst,
            n_edges=int(src_l.size),
        )
