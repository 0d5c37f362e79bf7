"""Synthetic graph generators (numpy; the port's own copy of the serving
generators in ``repro.graph.generators``).

Graphs whose shape matches what the paper's claims depend on: power-law
degree distribution, small diameter, and community structure so hotspot
workloads have overlapping neighbourhoods. All generators are deterministic
given `seed`, and give the same arrays as the reference package.
"""

from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSRGraph, build_csr, make_bidirected


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
    # endpoint pool for degree-biased sampling
    pool = np.concatenate([src[:k], dst[:k]])
    pool_list = [pool]
    batch = max(1024, m * 64)
    u = m + 1
    while u < n:
        ub = min(n, u + batch)
        cnt = (ub - u) * m
        flat_pool = np.concatenate(pool_list) if len(pool_list) > 1 else pool_list[0]
        pool_list = [flat_pool]
        # sample degree-biased targets for the whole batch at once; clip to
        # nodes that exist at the *start* of the batch (slight approximation,
        # preserves the power law)
        targets = flat_pool[rng.integers(0, flat_pool.size, size=cnt)]
        news = np.repeat(np.arange(u, ub, dtype=np.int64), m)
        targets = np.where(targets >= news, (targets % np.maximum(news, 1)), targets)
        src[k : k + cnt] = news
        dst[k : k + cnt] = targets
        k += cnt
        pool_list.append(news)
        pool_list.append(targets)
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
