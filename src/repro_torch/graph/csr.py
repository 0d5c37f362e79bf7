"""CSR graph structures (numpy; the port's own copy of ``repro.graph.csr``).

Two layouts are used throughout the framework:

- ``CSRGraph``: classic (indptr, indices) compressed sparse rows. Host-side
  (numpy) canonical representation; all generators produce this.
- ``PaddedAdjacency``: fixed-width neighbor matrix ``(n, max_degree)`` with a
  per-node ``degree`` vector, padded with ``-1``.  This is the device layout:
  it is what the decoupled storage tier shards, what the processor cache
  stores rows of, and what the frontier kernels consume.  RAMCloud stored
  variable-length adjacency values; a device row is fixed-shape.  For
  power-law graphs we cap ``max_degree`` and spill the overflow into
  *continuation rows* (virtual node ids >= n chaining the remainder),
  preserving exact adjacency.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    """Host-side CSR graph. Directed; see make_bidirected for the bi-directed view."""

    n: int
    indptr: np.ndarray  # (n+1,) int64
    indices: np.ndarray  # (e,) int32/int64

    @property
    def e(self) -> int:
        return int(self.indices.shape[0])

    def degree(self) -> np.ndarray:
        return np.diff(self.indptr)

    def neighbors(self, u: int) -> np.ndarray:
        return self.indices[self.indptr[u] : self.indptr[u + 1]]


@dataclasses.dataclass
class PaddedAdjacency:
    """Fixed-width adjacency rows; device/storage layout.

    rows:   (n_rows, max_degree) int32, -1 padded.
    degree: (n_rows,) int32 -- number of valid entries in each row (including a
            possible continuation pointer slot, see ``cont``).
    cont:   (n_rows,) int32 -- continuation row id (>= n base rows) or -1.
            Rows whose true degree exceeds max_degree chain into continuation
            rows appended after the n base rows.
    n:      number of *real* nodes (base rows); n_rows >= n.
    """

    n: int
    rows: np.ndarray
    degree: np.ndarray
    cont: np.ndarray

    @property
    def n_rows(self) -> int:
        return int(self.rows.shape[0])

    @property
    def max_degree(self) -> int:
        return int(self.rows.shape[1])


def sorted_unique(a: np.ndarray, return_index: bool = False):
    """`np.unique(a)` (and the first index of each value with return_index)
    by one sort and a flag of the first of each run: the same arrays.
    numpy 2.3's `np.unique` took 199 s on 57 M int64 keys where `np.sort`
    took 1.1 s."""
    a = np.asarray(a).ravel()
    order = np.argsort(a, kind="stable") if return_index else None
    s = a[order] if return_index else np.sort(a)
    first = np.empty(s.size, bool)
    first[:1] = True
    np.not_equal(s[1:], s[:-1], out=first[1:])
    return (s[first], order[first]) if return_index else s[first]


def build_csr(n: int, src: np.ndarray, dst: np.ndarray, dedup: bool = True) -> CSRGraph:
    """Build CSR from an edge list (directed src->dst)."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if dedup and src.size:
        key = sorted_unique(src * n + dst)
        src, dst = key // n, key % n
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    counts = np.bincount(src, minlength=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSRGraph(n=n, indptr=indptr, indices=dst.astype(np.int32))


def make_bidirected(g: CSRGraph) -> CSRGraph:
    """Union of edges and reversed edges (paper: every edge treated bi-directed
    because both in- and out-neighbors are stored per node)."""
    src = np.repeat(np.arange(g.n, dtype=np.int64), np.diff(g.indptr))
    dst = g.indices.astype(np.int64)
    all_src = np.concatenate([src, dst])
    all_dst = np.concatenate([dst, src])
    return build_csr(g.n, all_src, all_dst, dedup=True)


def to_padded(g: CSRGraph, max_degree: Optional[int] = None) -> PaddedAdjacency:
    """Convert CSR to the padded storage layout with continuation rows.

    If max_degree is None, uses the true max degree (no continuations).
    """
    deg = np.diff(g.indptr).astype(np.int64)
    true_max = int(deg.max()) if g.n else 0
    if max_degree is None:
        max_degree = max(true_max, 1)
    max_degree = max(int(max_degree), 2)  # need >= 2 for continuation chaining

    # Every row holds up to max_degree entries; the chain pointer is kept
    # out-of-band in cont[], so chained rows lose no payload capacity. Node
    # u's k-th row (k >= 1) is continuation row first[u] + k - 1: the
    # continuation rows follow the n base rows in node order.
    W = max_degree
    n_chunks = np.maximum(1, -(-deg // W))  # rows of each node
    n_chain = n_chunks - 1
    total_rows = g.n + int(n_chain.sum())
    first = g.n + np.cumsum(n_chain) - n_chain

    def row_of(u, k):
        return np.where(k == 0, u, first[u] + k - 1)

    rows = np.full((total_rows, W), -1, dtype=np.int32)
    degree = np.zeros((total_rows,), dtype=np.int32)
    cont = np.full((total_rows,), -1, dtype=np.int32)
    # every edge: its node's row, by its position in the node's list
    u = np.repeat(np.arange(g.n, dtype=np.int64), deg)
    pos = np.arange(u.size, dtype=np.int64) - g.indptr[:-1][u]
    rows[row_of(u, pos // W), pos % W] = g.indices
    # every row: its entry count and the row it continues into
    u = np.repeat(np.arange(g.n, dtype=np.int64), n_chunks)
    k = np.arange(u.size, dtype=np.int64) - np.repeat(np.cumsum(n_chunks) - n_chunks, n_chunks)
    r = row_of(u, k)
    degree[r] = np.minimum(W, deg[u] - k * W)
    cont[r] = np.where(k < n_chunks[u] - 1, first[u] + k, -1)
    return PaddedAdjacency(n=g.n, rows=rows, degree=degree, cont=cont)


def csr_to_edge_index(g: CSRGraph) -> Tuple[np.ndarray, np.ndarray]:
    """(src, dst) int32 arrays -- the GNN edge-index layout."""
    src = np.repeat(np.arange(g.n, dtype=np.int32), np.diff(g.indptr))
    return src, g.indices.astype(np.int32)
