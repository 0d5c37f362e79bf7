"""Synthetic graph generators (numpy; the port's own copy of
``repro.graph.generators``).

Graphs whose shape matches what the paper's claims depend on: power-law
degree distribution, small diameter, and community structure so hotspot
workloads have overlapping neighbourhoods; and the topologies the GNN zoo
trains on: random (Erdos-Renyi) and grid graphs, a Cora-like citation
graph with features and labels (full_graph_sm), batches of small molecular
graphs (molecule) and GraphCast's icosahedral multimesh. All generators
are deterministic given `seed`, and give the same arrays as the reference
package.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.graph.csr import CSRGraph, build_csr, make_bidirected, sorted_unique


def powerlaw_graph(n: int, m: int = 8, seed: int = 0, bidirect: bool = True) -> CSRGraph:
    """Barabasi-Albert-style preferential attachment: power-law degrees, small
    diameter -- matches the paper's social/web graphs in shape.

    Vectorized approximate preferential attachment: each new node attaches m
    edges to targets sampled from the current edge endpoints (degree-biased).
    """
    rng = np.random.default_rng(seed)
    m = max(1, min(m, n - 1))
    src = np.zeros(n * m, dtype=np.int64)
    dst = np.zeros(n * m, dtype=np.int64)
    # seed clique over first m+1 nodes
    k = 0
    for u in range(1, m + 1):
        for v in range(u):
            src[k], dst[k] = u, v
            k += 1
    # endpoint pool for degree-biased sampling: the clique's sources and
    # targets, then each batch's new nodes and their targets, in that order
    # in one buffer; a batch draws from the part filled before it
    pool = np.empty(2 * k + 2 * max(n - m - 1, 0) * m, dtype=np.int64)
    pool[:k], pool[k : 2 * k] = src[:k], dst[:k]
    filled = 2 * k
    batch = max(1024, m * 64)
    u = m + 1
    while u < n:
        ub = min(n, u + batch)
        cnt = (ub - u) * m
        # sample degree-biased targets for the whole batch at once; clip to
        # nodes that exist at the *start* of the batch (slight approximation,
        # preserves the power law)
        targets = pool[rng.integers(0, filled, size=cnt)]
        news = np.repeat(np.arange(u, ub, dtype=np.int64), m)
        targets = np.where(targets >= news, (targets % np.maximum(news, 1)), targets)
        src[k : k + cnt] = news
        dst[k : k + cnt] = targets
        k += cnt
        pool[filled : filled + cnt] = news
        pool[filled + cnt : filled + 2 * cnt] = targets
        filled += 2 * cnt
        u = ub
    g = build_csr(n, src[:k], dst[:k], dedup=True)
    return make_bidirected(g) if bidirect else g


# Named scale presets for the serving runs. "large" (262,144 nodes) is where
# the bit-packed visited layout matters: one round's dense per-query state is
# B * 256 KB, the packed words B * 32 KB. n is a multiple of 32, so packed
# rows have no partial trailing word.
POWERLAW_PRESETS = {
    "small": dict(n=4_800, m=6),
    "medium": dict(n=48_000, m=8),
    "large": dict(n=262_144, m=8),
}


def powerlaw_preset(name: str, seed: int = 0, bidirect: bool = True) -> CSRGraph:
    """Build a named power-law preset (see POWERLAW_PRESETS)."""
    if name not in POWERLAW_PRESETS:
        raise ValueError(
            f"unknown preset {name!r}; one of {tuple(POWERLAW_PRESETS)}")
    return powerlaw_graph(seed=seed, bidirect=bidirect, **POWERLAW_PRESETS[name])


def community_graph(
    n: int,
    community_size: int = 60,
    intra_degree: float = 6.0,
    inter_degree: float = 1.0,
    zipf_a: float = 1.6,
    seed: int = 0,
) -> CSRGraph:
    """Clustered power-law graph: web/social graphs are locally dense,
    globally sparse.

    Communities of ``community_size`` nodes arranged on a ring; intra-
    community edges target Zipf-popular nodes (per-community hubs -> degree
    skew); inter-community edges connect ring-adjacent communities only.
    h-hop neighborhoods therefore stay O(community), and nearby nodes have
    overlapping neighborhoods.
    """
    rng = np.random.default_rng(seed)
    n_comm = max(1, n // community_size)
    n = n_comm * community_size
    comm = np.arange(n) // community_size

    # intra-community: Zipf-popular targets (hubs)
    e_intra = int(n * intra_degree / 2)
    src = rng.integers(0, n, size=e_intra)
    pop = rng.zipf(zipf_a, size=e_intra) % community_size  # popular ranks
    dst = comm[src] * community_size + pop
    # inter-community: ring edges to the next community
    e_inter = int(n * inter_degree / 2)
    s2 = rng.integers(0, n, size=e_inter)
    nxt = (comm[s2] + 1) % n_comm
    d2 = nxt * community_size + rng.integers(0, community_size, size=e_inter)
    all_src = np.concatenate([src, s2])
    all_dst = np.concatenate([dst, d2])
    keep = all_src != all_dst
    g = build_csr(n, all_src[keep], all_dst[keep])
    return make_bidirected(g)


def erdos_renyi_graph(n: int, avg_degree: float = 8.0, seed: int = 0) -> CSRGraph:
    rng = np.random.default_rng(seed)
    e = int(n * avg_degree / 2)
    src = rng.integers(0, n, size=e)
    dst = rng.integers(0, n, size=e)
    keep = src != dst
    return make_bidirected(build_csr(n, src[keep], dst[keep]))


def grid_graph(side: int) -> CSRGraph:
    """2D grid; high-diameter counterpoint for routing tests."""
    n = side * side
    ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    u = (ii * side + jj).ravel()
    right = np.stack([u[(jj.ravel() < side - 1)], u[(jj.ravel() < side - 1)] + 1], 1)
    down = np.stack([u[(ii.ravel() < side - 1)], u[(ii.ravel() < side - 1)] + side], 1)
    edges = np.concatenate([right, down], 0)
    return make_bidirected(build_csr(n, edges[:, 0], edges[:, 1]))


def cora_like_graph(
    n: int = 2708, e_target: int = 10556, d_feat: int = 1433, n_classes: int = 7, seed: int = 0
) -> Tuple[CSRGraph, np.ndarray, np.ndarray]:
    """Citation-style graph + sparse bag-of-words features + labels.

    Shape-matches the full_graph_sm cell (Cora: 2708 nodes, 10556 edges, 1433 feats).
    Community structure: nodes get a class; intra-class edges preferred.
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, size=n)
    e = e_target // 2
    src = rng.integers(0, n, size=3 * e)
    # prefer same-class targets
    same = np.flatnonzero(rng.random(3 * e) < 0.7)
    dst = rng.integers(0, n, size=3 * e)
    for idx in same:
        cls = labels[src[idx]]
        members = np.flatnonzero(labels == cls)
        dst[idx] = members[rng.integers(0, members.size)]
    keep = src != dst
    src, dst = src[keep][:e], dst[keep][:e]
    g = make_bidirected(build_csr(n, src, dst))
    feats = (rng.random((n, d_feat)) < 0.012).astype(np.float32)
    return g, feats, labels.astype(np.int32)


def molecule_batch_graph(
    n_mols: int, n_nodes: int = 30, n_edges: int = 64, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched small molecular graphs for EGNN/molecule shape.

    Returns (src, dst, graph_id) for a disjoint union of n_mols random
    connected graphs of n_nodes/n_edges each. Node ids are globally offset.
    """
    rng = np.random.default_rng(seed)
    srcs, dsts, gids = [], [], []
    for i in range(n_mols):
        off = i * n_nodes
        # random spanning tree + extra edges => connected
        perm = rng.permutation(n_nodes)
        tree_src = perm[1:]
        tree_dst = perm[rng.integers(0, np.arange(1, n_nodes))]
        extra = n_edges // 2 - (n_nodes - 1)
        ex_src = rng.integers(0, n_nodes, size=max(extra, 0))
        ex_dst = rng.integers(0, n_nodes, size=max(extra, 0))
        s = np.concatenate([tree_src, ex_src]) + off
        d = np.concatenate([tree_dst, ex_dst]) + off
        srcs.append(np.concatenate([s, d]))  # bidirect
        dsts.append(np.concatenate([d, s]))
        gids.append(np.full(2 * s.size, i, dtype=np.int32))
    return (
        np.concatenate(srcs).astype(np.int32),
        np.concatenate(dsts).astype(np.int32),
        np.concatenate(gids),
    )


@dataclasses.dataclass
class Multimesh:
    """GraphCast-style icosahedral multimesh."""

    n_grid: int
    n_mesh: int
    mesh_src: np.ndarray  # mesh-mesh edges (all refinement levels merged)
    mesh_dst: np.ndarray
    g2m_src: np.ndarray  # grid -> mesh edges
    g2m_dst: np.ndarray
    m2g_src: np.ndarray  # mesh -> grid edges
    m2g_dst: np.ndarray


def icosahedral_multimesh(refinement: int = 6, grid_per_mesh: int = 4, seed: int = 0) -> Multimesh:
    """Build an icosahedron refined `refinement` times; multimesh = union of
    edges from ALL refinement levels (GraphCast [arXiv:2212.12794]).

    Grid nodes are synthetic lat-lon points each connected to nearby mesh
    nodes (here: `grid_per_mesh` grid points per finest mesh node, connected
    to that node and its mesh neighbors), which preserves the
    encoder-processor-decoder dataflow shape without geodesy dependencies.
    """
    # icosahedron
    t = (1.0 + 5**0.5) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )

    all_src, all_dst = [], []

    def add_level_edges(fcs):
        e = np.concatenate([fcs[:, [0, 1]], fcs[:, [1, 2]], fcs[:, [2, 0]]], 0)
        all_src.append(e[:, 0])
        all_dst.append(e[:, 1])

    add_level_edges(faces)
    for _ in range(refinement):
        # split each face into 4, de-duplicating midpoints via an edge dict
        new_faces = []
        mids = {}
        extra = []
        base_n = verts.shape[0]
        for f in faces:
            ab = tuple(sorted((f[0], f[1])))
            bc = tuple(sorted((f[1], f[2])))
            ca = tuple(sorted((f[2], f[0])))
            for key in (ab, bc, ca):
                if key not in mids:
                    mids[key] = base_n + len(extra)
                    p = verts[key[0]] + verts[key[1]]
                    extra.append(p / np.linalg.norm(p))
            m_ab, m_bc, m_ca = mids[ab], mids[bc], mids[ca]
            new_faces.append([f[0], m_ab, m_ca])
            new_faces.append([f[1], m_bc, m_ab])
            new_faces.append([f[2], m_ca, m_bc])
            new_faces.append([m_ab, m_bc, m_ca])
        verts = np.concatenate([verts, np.array(extra)], 0)
        faces = np.array(new_faces, dtype=np.int64)
        add_level_edges(faces)

    n_mesh = verts.shape[0]
    src = np.concatenate(all_src)
    dst = np.concatenate(all_dst)
    # bidirect + dedup
    s2 = np.concatenate([src, dst])
    d2 = np.concatenate([dst, src])
    key = s2 * n_mesh + d2
    key = sorted_unique(key)
    mesh_src, mesh_dst = (key // n_mesh).astype(np.int32), (key % n_mesh).astype(np.int32)

    # synthetic grid <-> mesh connectivity
    rng = np.random.default_rng(seed)
    n_grid = n_mesh * grid_per_mesh
    grid_ids = np.arange(n_grid, dtype=np.int32)
    home = grid_ids // grid_per_mesh  # each grid point's home mesh node
    g2m_src = grid_ids
    g2m_dst = home.astype(np.int32)
    # also connect each grid point to one random neighbor of its home node
    # (approximates the ~3 mesh nodes per grid point of GraphCast)
    order = np.argsort(mesh_src, kind="stable")
    ms, md = mesh_src[order], mesh_dst[order]
    first = np.searchsorted(ms, np.arange(n_mesh))
    counts = np.searchsorted(ms, np.arange(n_mesh) + 1) - first
    pick = first[home] + rng.integers(0, np.maximum(counts[home], 1))
    extra_dst = md[np.minimum(pick, md.size - 1)]
    g2m_src = np.concatenate([g2m_src, grid_ids]).astype(np.int32)
    g2m_dst = np.concatenate([g2m_dst, extra_dst]).astype(np.int32)
    m2g_src, m2g_dst = g2m_dst.copy(), g2m_src.copy()
    return Multimesh(
        n_grid=n_grid,
        n_mesh=n_mesh,
        mesh_src=mesh_src,
        mesh_dst=mesh_dst,
        g2m_src=g2m_src,
        g2m_dst=g2m_dst,
        m2g_src=m2g_src,
        m2g_dst=m2g_dst,
    )
