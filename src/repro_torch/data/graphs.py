"""GNN batch builders for the zoo's graph shapes (numpy; the reference's
`data/graphs.py`, the same arrays from the same seeds).

full_graph_*  -- one static batch (whole graph, padded edge index)
minibatch_lg  -- per-step sampled subgraph via the fanout NeighborSampler
molecule      -- per-step batch of random small graphs (graph regression:
                 `graph_id` and `graph_targets`, no node labels)
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.graph.csr import CSRGraph, csr_to_edge_index
from repro_torch.graph.generators import molecule_batch_graph
from repro_torch.graph.sampler import NeighborSampler


def full_graph_batch(
    g: CSRGraph, feats: np.ndarray, labels: np.ndarray, with_pos: bool = True, seed: int = 0
) -> dict:
    src, dst = csr_to_edge_index(g)
    rng = np.random.default_rng(seed)
    batch = {
        "node_feat": feats.astype(np.float32),
        "src": src.astype(np.int32),
        "dst": dst.astype(np.int32),
        "labels": labels.astype(np.int32),
    }
    if with_pos:
        batch["node_pos"] = rng.standard_normal((g.n, 3)).astype(np.float32)
    return batch


def gnn_batch(
    step: int,
    g: CSRGraph,
    feats: np.ndarray,
    labels: np.ndarray,
    sampler: Optional[NeighborSampler] = None,
    batch_nodes: int = 1024,
    seed: int = 0,
) -> dict:
    """Sampled-minibatch batch (static shapes via sampler padding): a
    fresh draw of `batch_nodes` seeds each step; loss on the seeds only
    (`seed_mask`)."""
    if sampler is None:
        raise ValueError("gnn_batch needs a NeighborSampler")
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    seeds = rng.choice(g.n, size=batch_nodes, replace=False)
    sub = sampler.sample(seeds)
    nvalid = sub.nodes >= 0
    nf = np.zeros((sub.max_nodes, feats.shape[1]), np.float32)
    nf[nvalid] = feats[sub.nodes[nvalid]]
    lb = np.zeros((sub.max_nodes,), np.int32)
    lb[nvalid] = labels[sub.nodes[nvalid]]
    seed_mask = np.zeros((sub.max_nodes,), np.float32)
    seed_mask[: batch_nodes] = 1.0
    pos = rng.standard_normal((sub.max_nodes, 3)).astype(np.float32)
    return {
        "node_feat": nf,
        "node_pos": pos,
        "src": sub.src,
        "dst": sub.dst,
        "labels": lb,
        "seed_mask": seed_mask,
    }


def molecule_batch(
    step: int, n_mols: int = 128, n_nodes: int = 30, n_edges: int = 64,
    d_feat: int = 16, seed: int = 0,
) -> dict:
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    src, dst, _ = molecule_batch_graph(n_mols, n_nodes, n_edges, seed=seed + step)
    N = n_mols * n_nodes
    gid = (np.arange(N) // n_nodes).astype(np.int32)
    pos = rng.standard_normal((N, 3)).astype(np.float32)
    feat = rng.standard_normal((N, d_feat)).astype(np.float32)
    # synthetic energy target: function of mean pairwise distance per graph
    tgt = np.zeros((n_mols, 1), np.float32)
    for i in range(n_mols):
        p = pos[i * n_nodes : (i + 1) * n_nodes]
        tgt[i, 0] = np.mean(np.linalg.norm(p - p.mean(0), axis=1))
    return {
        "node_feat": feat,
        "node_pos": pos,
        "src": src,
        "dst": dst,
        "graph_id": gid,
        "graph_targets": tgt,
    }
