"""The cases of tests/test_torch_graph_serving.py, shared by the reference
runner (`_graph_serving_ref.py`, JAX) and the port's workers
(`_torch_dist.py`, torch): numpy and plain values only.

Every case serves the same small graph, `powerlaw_graph(256, 3)` padded to
rows of 8 (hubs of up to 163 neighbours take chains of up to 21 rows), with
8 queries a processor, over two steps of the same queries.
"""

from __future__ import annotations

import numpy as np

GRAPH = dict(n=256, m=3, seed=0)
MAX_DEGREE = 8
QPP = 8  # queries a processor
EMBED_DIM = 10
MESHES = ((1, 1), (2, 2), (1, 4), (4, 1))  # (data, model)
BASE = dict(queries_per_proc=QPP, hops=2, max_frontier=256, cache_sets=128, cache_ways=4,
            chain_depth=24)
# read_capacity / read_retry of each case: roomy (a budget of every id a
# processor can send in one read, QPP x max_frontier, so nothing can
# overflow, and one round), a budget of 16 that the retries serve in full,
# and the reference's silent loss (a budget of 4, one round: what
# overflows comes back empty)
CASES = {
    "roomy": dict(read_capacity=QPP * BASE["max_frontier"], read_retry=1),
    "retry": dict(read_capacity=16, read_retry=4),
    "exhausted": dict(read_capacity=4, read_retry=1),
}
# a hub query on rank 0 of the first storage group, none on its rank 1;
# a leaf on rank 2, none on rank 3: each group's loop runs its busy rank's
# links on both ranks
SYNC_MESH = (2, 2)
# admission: 1.5x-oversubscribed bursts through a ring of RING[mesh]
# slots, then the drain
ADMISSION = {(2, 2): ("next_ready", "embed"), (1, 1): ("next_ready",)}
RING = {(2, 2): 12, (1, 1): 6}
BURSTS = 3
STEPS = 2


def mesh_name(mesh) -> str:
    return f"{mesh[0]}x{mesh[1]}"


def arrivals(mesh) -> int:
    P = mesh[0] * mesh[1]
    return P * QPP + P * QPP // 2


def config(mesh, case: str, n_nodes: int, n_rows: int) -> dict:
    """GServeConfig's fields for `case` on `mesh` (both packages')."""
    return dict(BASE, **CASES[case], n_nodes=n_nodes, n_rows=n_rows, row_width=MAX_DEGREE,
                n_storage_shards=mesh[1])


def inputs(mesh, n: int, seed: int = 1) -> dict:
    """The queries (n_proc, QPP), coordinates (n, D) and EMA (n_proc, D)."""
    rng = np.random.default_rng(seed)
    P = mesh[0] * mesh[1]
    return dict(queries=rng.integers(0, n, (P, QPP)).astype(np.int32),
                coords=rng.standard_normal((n, EMBED_DIM)).astype(np.float32),
                ema=rng.standard_normal((P, EMBED_DIM)).astype(np.float32))


def sync_queries(degree: np.ndarray) -> np.ndarray:
    q = np.full((4, QPP), -1, np.int32)
    q[0, 0] = int(np.argmax(degree))
    q[2, 0] = int(np.argmin(degree))
    return q
