"""Graph partitioners (numpy; the port's own copy of ``repro.graph.partition``).

The paper's storage tier uses inexpensive hash partitioning (RAMCloud
MurmurHash3 over node ids); its competitors use expensive partitioning
(ParMETIS in SEDGE, node-cuts in PowerGraph).

- ``hash_partition``: the paper's choice, ``splitmix64`` (the
  MurmurHash-grade avalanche the storage placement uses too) mod S.
- ``label_propagation_partition``: a representative expensive, good-quality
  partitioner (balanced label propagation, Ugander & Backstrom WSDM'13
  style), the SEDGE / PowerGraph stand-in that feeds the coupled baseline
  (``core.serving.run_coupled_baseline``) favourable locality.
- ``edge_cut``: the evaluation metric.
"""

from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSRGraph


def splitmix64(x: np.ndarray) -> np.ndarray:
    """SplitMix64 avalanche hash (vectorized); MurmurHash3-grade mixing."""
    x = np.asarray(x, dtype=np.uint64)
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    z = x
    z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    return z ^ (z >> np.uint64(31))


def hash_partition(n: int, n_parts: int, seed: int = 0) -> np.ndarray:
    """Paper's storage partitioning: hash(node) mod S. O(n), no graph needed."""
    h = splitmix64(np.arange(n, dtype=np.uint64) + np.uint64(seed * 0x5851F42D4C957F2D))
    return (h % np.uint64(n_parts)).astype(np.int32)


def label_propagation_partition(
    g: CSRGraph, n_parts: int, n_iters: int = 10, balance_slack: float = 0.1, seed: int = 0
) -> np.ndarray:
    """Balanced label propagation: each node adopts the most common partition
    among its neighbours, subject to a per-partition capacity. The
    'expensive partitioning' baseline (stands in for ParMETIS / SEDGE)."""
    rng = np.random.default_rng(seed)
    labels = hash_partition(g.n, n_parts, seed)
    cap = int(np.ceil(g.n / n_parts * (1.0 + balance_slack)))
    src = np.repeat(np.arange(g.n, dtype=np.int64), np.diff(g.indptr))
    dst = g.indices.astype(np.int64)
    for _ in range(n_iters):
        # per-node histogram of neighbour labels via bincount on (node, label)
        key = src * n_parts + labels[dst]
        hist = np.bincount(key, minlength=g.n * n_parts).reshape(g.n, n_parts)
        want = hist.argmax(1).astype(np.int32)
        gain = hist[np.arange(g.n), want] - hist[np.arange(g.n), labels]
        movers = np.flatnonzero((want != labels) & (gain > 0))
        if movers.size == 0:
            break
        # movers in a random order, each while its target has room
        rng.shuffle(movers)
        counts = np.bincount(labels, minlength=n_parts)
        for u in movers:
            w = want[u]
            if counts[w] < cap:
                counts[labels[u]] -= 1
                counts[w] += 1
                labels[u] = w
    return labels


def edge_cut(g: CSRGraph, labels: np.ndarray) -> float:
    """Fraction of edges crossing partitions."""
    src = np.repeat(np.arange(g.n, dtype=np.int64), np.diff(g.indptr))
    if g.e == 0:
        return 0.0
    return float(np.mean(labels[src] != labels[g.indices]))
