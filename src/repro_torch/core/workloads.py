"""Online query workload generators (numpy; the port's own copy of
``repro.core.workloads``; paper §4.2, Figure 7).

  - r-hop hotspot:    hotspot centers uniform at random; query nodes within
                      r hops of each center, consecutive per hotspot.
  - concentrated:     r = 0: each center queried `reps` times in a row.
  - uniform:          uniform query nodes.
  - drifting hotspot: hotspot centers random-walk between phases -- the
                      locality a smart router must track online (EMA drift).
  - anti-locality:    distinct nodes, every window spread out in id space
                      (golden-ratio stride): the no-reuse worst case.
  - preset:           half hotspot, half uniform over a power-law preset.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.graph.csr import CSRGraph

QUERY_TYPES = ("aggregation", "random_walk", "reachability")


@dataclasses.dataclass
class Workload:
    name: str
    query_nodes: np.ndarray  # (Q,) int32
    query_types: np.ndarray  # (Q,) int8 index into QUERY_TYPES
    targets: np.ndarray  # (Q,) int32 -- second endpoint for reachability, else -1
    hotspot_id: np.ndarray  # (Q,) int32 -- which hotspot (-1 for uniform)


def _ball_sample(g: CSRGraph, center: int, r: int, k: int, rng) -> np.ndarray:
    """Sample k nodes within r hops of center (BFS ball, then choice)."""
    ball = {center}
    frontier = [center]
    for _ in range(r):
        nxt = []
        for u in frontier:
            for v in g.neighbors(u):
                if v not in ball:
                    ball.add(int(v))
                    nxt.append(int(v))
            if len(ball) > 50 * k:
                break
        frontier = nxt
        if not frontier:
            break
    arr = np.fromiter(ball, dtype=np.int64)
    return rng.choice(arr, size=k, replace=arr.size < k)


def _mix_types(q: int, rng, reach_targets: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    types = rng.integers(0, len(QUERY_TYPES), size=q).astype(np.int8)
    targets = np.where(types == 2, reach_targets, -1).astype(np.int32)
    return types, targets


def hotspot_workload(
    g: CSRGraph,
    r: int = 2,
    n_hotspots: int = 100,
    queries_per_hotspot: int = 10,
    seed: int = 0,
) -> Workload:
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, g.n, size=n_hotspots)
    nodes: List[np.ndarray] = []
    hs: List[np.ndarray] = []
    for i, c in enumerate(centers):
        qs = (
            np.full(queries_per_hotspot, c, dtype=np.int64)
            if r == 0
            else _ball_sample(g, int(c), r, queries_per_hotspot, rng)
        )
        nodes.append(qs)
        hs.append(np.full(queries_per_hotspot, i, dtype=np.int32))
    qn = np.concatenate(nodes).astype(np.int32)
    types, targets = _mix_types(qn.size, rng, rng.integers(0, g.n, qn.size).astype(np.int32))
    return Workload(
        name=f"{r}-hop-hotspot" if r > 0 else "concentrated",
        query_nodes=qn,
        query_types=types,
        targets=targets,
        hotspot_id=np.concatenate(hs),
    )


def concentrated_workload(g: CSRGraph, n_hotspots: int = 100, reps: int = 10, seed: int = 0):
    return hotspot_workload(g, r=0, n_hotspots=n_hotspots, queries_per_hotspot=reps, seed=seed)


def drifting_hotspot_workload(
    g: CSRGraph,
    n_phases: int = 4,
    n_hotspots: int = 16,
    queries_per_hotspot: int = 6,
    r: int = 1,
    drift_hops: int = 2,
    seed: int = 0,
) -> Workload:
    """Hotspot centers random-walk `drift_hops` steps between phases."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, g.n, size=n_hotspots).astype(np.int64)
    nodes: List[np.ndarray] = []
    hs: List[np.ndarray] = []
    for _phase in range(n_phases):
        for i in range(n_hotspots):
            c = int(centers[i])
            qs = (
                np.full(queries_per_hotspot, c, dtype=np.int64)
                if r == 0
                else _ball_sample(g, c, r, queries_per_hotspot, rng)
            )
            nodes.append(qs)
            hs.append(np.full(queries_per_hotspot, i, dtype=np.int32))
        for i in range(n_hotspots):
            c = int(centers[i])
            for _ in range(drift_hops):
                nb = g.neighbors(c)
                if nb.size:
                    c = int(nb[rng.integers(nb.size)])
            centers[i] = c
    qn = np.concatenate(nodes).astype(np.int32)
    types, targets = _mix_types(qn.size, rng, rng.integers(0, g.n, qn.size).astype(np.int32))
    return Workload(
        name="drifting-hotspot",
        query_nodes=qn,
        query_types=types,
        targets=targets,
        hotspot_id=np.concatenate(hs),
    )


def antilocality_workload(g: CSRGraph, n_queries: int = 256, seed: int = 0) -> Workload:
    """Distinct query nodes with every window of k consecutive queries spread
    ~n/k apart in id space: the stride is the golden-ratio conjugate of n
    (three-distance theorem), made coprime with n so it is a permutation."""
    rng = np.random.default_rng(seed)
    n_queries = min(n_queries, g.n)
    stride = max(round(g.n * 0.6180339887498949), 1)
    while stride > 1 and math.gcd(stride, g.n) != 1:
        stride -= 1
    start = int(rng.integers(g.n))
    qn = ((start + np.arange(n_queries, dtype=np.int64) * stride) % g.n).astype(np.int32)
    types, targets = _mix_types(qn.size, rng, rng.integers(0, g.n, qn.size).astype(np.int32))
    return Workload(
        name="anti-locality",
        query_nodes=qn,
        query_types=types,
        targets=targets,
        hotspot_id=np.full(qn.size, -1, np.int32),
    )


def preset_workload(
    preset: str = "large",
    n_queries: int = 64,
    seed: int = 0,
    graph: Optional[CSRGraph] = None,
) -> Tuple[CSRGraph, Workload]:
    """Graph + mixed stream for a named power-law scale preset: the hotspot
    half warms caches, the uniform half sprays the full id range so every
    word of a packed visited set is exercised. Returns exactly `n_queries`
    queries."""
    from repro_torch.graph.generators import powerlaw_preset

    g = graph if graph is not None else powerlaw_preset(preset, seed=seed)
    n_hot_q = n_queries // 2
    qph = min(8, max(1, n_hot_q))
    hot = hotspot_workload(
        g, r=1, n_hotspots=max(1, n_hot_q // qph), queries_per_hotspot=qph,
        seed=seed,
    )
    uni = uniform_workload(
        g, n_queries=max(0, n_queries - hot.query_nodes.size), seed=seed + 1)
    wl = Workload(
        name=f"preset-{preset}",
        query_nodes=np.concatenate([hot.query_nodes, uni.query_nodes])[:n_queries],
        query_types=np.concatenate([hot.query_types, uni.query_types])[:n_queries],
        targets=np.concatenate([hot.targets, uni.targets])[:n_queries],
        hotspot_id=np.concatenate([hot.hotspot_id, uni.hotspot_id])[:n_queries],
    )
    return g, wl


def uniform_workload(g: CSRGraph, n_queries: int = 1000, seed: int = 0) -> Workload:
    rng = np.random.default_rng(seed)
    qn = rng.integers(0, g.n, size=n_queries).astype(np.int32)
    types, targets = _mix_types(qn.size, rng, rng.integers(0, g.n, qn.size).astype(np.int32))
    return Workload(
        name="uniform",
        query_nodes=qn,
        query_types=types,
        targets=targets,
        hotspot_id=np.full(qn.size, -1, np.int32),
    )
