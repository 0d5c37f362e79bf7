"""Event-driven throughput simulator of the gRouting cluster (numpy; the
port's own copy of ``repro.core.serving``).

``ServingSimulator`` is the harness behind the paper's throughput, latency
and hit-rate rows. Queries are executed faithfully on the host (BFS order,
per-processor LRU cache contents, storage round trips) and the service
time of each query comes from the calibrated cost model
(``core.costmodel``): its qps and milliseconds are derivations for the
paper's RAMCloud cluster, not times of the card. Routing, queueing and
query stealing are simulated event by event as the paper's router does
them (per-connection queues, ack-driven dispatch, steal-on-idle).

The simulator is an independent mirror of the port's device path
(``serve.engine.ServingEngine``, ``core.router``, ``core.dispatch``) and
shares no code with it, so that it can serve as its oracle:

  - the per-processor cache is a plain LRU (``OrderedDict``), the paper's
    exact eviction policy; the engine's set-associative LRU equals it
    wherever only cold misses occur;
  - the visited state is host numpy, whatever layout the engine runs
    (dense bool rows or packed words): the engine reports layout-free
    observables (counts, touch sets, read volumes, backlog evolution), so
    a layout or backend fault shows as a divergence here;
  - ``run_rounds`` mirrors the engine's continuous-batching loop: the same
    bounded carry-over backlog offered ahead of fresh arrivals, a numpy
    mirror of ``capacity_dispatch`` (``mirror_capacity_dispatch``) and the
    same drop-oldest admission, written independently in Python lists and
    numpy.

``run_coupled_baseline`` is the partition-coupled SEDGE / Giraph stand-in
(Fig. 8) behind the paper's "order of magnitude".
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.costmodel import CostModel, CoupledSystemModel, INFINIBAND
from repro_torch.core.embedding import GraphEmbedding
from repro_torch.core.landmarks import LandmarkIndex, UNREACHED
from repro_torch.core.workloads import Workload
from repro_torch.graph.csr import CSRGraph


# ---------------------------------------------------------------------------
# h-hop ball (the ground truth each query must touch)
# ---------------------------------------------------------------------------


def _neighbors_of(g: CSRGraph, nodes: np.ndarray, cap: Optional[int] = None) -> np.ndarray:
    """The adjacency lists of `nodes` concatenated in their order (int64),
    each cut to its first `cap` entries when `cap` is given."""
    starts = g.indptr[nodes]
    lens = g.indptr[nodes + 1] - starts
    if cap is not None:
        lens = np.minimum(lens, cap)
    offs = np.repeat(starts - (np.cumsum(lens) - lens), lens)
    return g.indices[offs + np.arange(offs.size)].astype(np.int64)


def hhop_ball(g: CSRGraph, q: int, h: int) -> Tuple[np.ndarray, int]:
    """BFS from q. Returns (touched = nodes whose adjacency is read, in BFS
    level order == multi_read order; result_size = |N_h(q)| incl. q).

    Algorithm 5 reads the adjacency of every node at depth 0..h-1. A level
    lists the nodes first reached from the level before in the order a
    scalar BFS meets them (the frontier's adjacency lists in turn), each
    once: the first occurrence of every unvisited id among those lists.
    """
    visited = np.zeros(g.n, dtype=bool)
    first = np.empty(g.n, dtype=np.int64)  # scratch: an id's first position
    visited[q] = True
    size = 1
    frontier = np.array([q], dtype=np.int64)
    touched = [np.zeros(0, dtype=np.int64)]
    for _ in range(h):
        touched.append(frontier)
        nb = _neighbors_of(g, frontier)
        pos = np.flatnonzero(~visited[nb])
        cand = nb[pos]
        first[cand] = nb.size
        np.minimum.at(first, cand, pos)
        frontier = cand[first[cand] == pos]
        visited[frontier] = True
        size += frontier.size
        if not frontier.size:
            break
    return np.concatenate(touched), size


def untruncated_size(g: CSRGraph, q: int, h: int, max_frontier: int,
                     max_degree: int) -> Optional[int]:
    """|N_h(q)| by `hhop_ball` when a serving step that caps a level at
    `max_frontier` nodes and a node's read at `max_degree` entries
    (row_width x chain_depth) reads every level 0..h-1 whole; None
    otherwise. Level k - 1 is what hhop_ball(q, k) adds to the touched
    nodes of hhop_ball(q, k - 1), so a query stops at its first level past
    a limit and no truncated ball is walked whole."""
    seen = 0
    for k in range(1, h + 1):
        touched, size = hhop_ball(g, q, k)
        level = touched[seen:]
        if level.size > max_frontier or (
                level.size and int((g.indptr[level + 1] - g.indptr[level]).max()) > max_degree):
            return None
        seen = touched.size
    return size


def capped_ball_size(g: CSRGraph, q: int, h: int, max_frontier: int, max_degree: int) -> int:
    """The number of nodes an h-hop search from q marks under the serving
    step's caps, truncated or not (q included): a hop reads the first
    `max_degree` entries of each frontier node's adjacency (row_width x
    chain_depth), marks every unmarked id it meets, and the next frontier
    is the lowest `max_frontier` of the ids it marked. Equal to
    hhop_ball's size wherever `untruncated_size` is not None."""
    visited = np.zeros(g.n, dtype=bool)
    visited[q] = True
    size = 1
    frontier = np.array([q], dtype=np.int64)
    for _ in range(h):
        nb = _neighbors_of(g, frontier, max_degree)
        new = np.unique(nb[~visited[nb]])
        visited[new] = True
        size += new.size
        frontier = new[:max_frontier]
        if not frontier.size:
            break
    return size


class BallCache:
    """Memoizes h-hop balls per (query, h)."""

    def __init__(self, g: CSRGraph):
        self.g = g
        self._memo: Dict[Tuple[int, int], Tuple[np.ndarray, int]] = {}

    def get(self, q: int, h: int) -> Tuple[np.ndarray, int]:
        key = (q, h)
        if key not in self._memo:
            self._memo[key] = hhop_ball(self.g, q, h)
        return self._memo[key]


# ---------------------------------------------------------------------------
# Host-side routing mirror: the router's math (core.router) in float64
# numpy, one query at a time
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SimRouterConfig:
    scheme: str = "embed"
    load_factor: float = 20.0
    alpha: float = 0.5
    steal_margin: float = 4.0


class SimRouter:
    def __init__(
        self,
        P: int,
        cfg: SimRouterConfig,
        landmark_index: Optional[LandmarkIndex] = None,
        embedding: Optional[GraphEmbedding] = None,
        seed: int = 0,
    ):
        self.P = P
        self.cfg = cfg
        self.scheme = cfg.scheme
        rng = np.random.default_rng(seed)
        self.dist_to_proc = None
        self.coords = None
        self.ema = None
        if cfg.scheme == "landmark":
            if landmark_index is None:
                raise ValueError("the landmark scheme needs a LandmarkIndex")
            d = landmark_index.dist_to_proc[:, :P].astype(np.float64)
            self.dist_to_proc = np.where(d >= float(UNREACHED), 1e6, d)
        elif cfg.scheme == "embed":
            if embedding is None:
                raise ValueError("the embed scheme needs a GraphEmbedding")
            self.coords = embedding.coords.astype(np.float64)
            lo, hi = self.coords.min(0), self.coords.max(0)
            self.ema = rng.uniform(0, 1, (P, self.coords.shape[1])) * (hi - lo) + lo
        self.rr = 0

    def route(self, q: int, load: np.ndarray) -> int:
        cfg = self.cfg
        if self.scheme == "next_ready" or self.scheme == "no_cache":
            p = int(np.argmin(load))
            self.rr += 1
            return p
        if self.scheme == "hash":
            x = np.uint32(q)
            x = np.uint32((int(x) ^ (int(x) >> 16)) * 0x7FEB352D & 0xFFFFFFFF)
            x = np.uint32((int(x) ^ (int(x) >> 15)) * 0x846CA68B & 0xFFFFFFFF)
            p0 = int((int(x) ^ (int(x) >> 16)) % self.P)
            idle = int(np.argmin(load))
            return idle if load[p0] - load[idle] > cfg.steal_margin else p0
        if self.scheme == "landmark":
            score = self.dist_to_proc[q] + load / cfg.load_factor
            return int(np.argmin(score))
        if self.scheme == "embed":
            x = self.coords[q]
            d1 = np.sqrt(((self.ema - x[None, :]) ** 2).sum(-1) + 1e-12)
            p = int(np.argmin(d1 + load / cfg.load_factor))
            a = cfg.alpha
            self.ema[p] = a * self.ema[p] + (1 - a) * x  # Eq. 5
            return p
        raise ValueError(self.scheme)


# ---------------------------------------------------------------------------
# numpy mirror of core.dispatch.capacity_dispatch (the queue-aware oracle:
# the same iterative best-choice passes, the same tie-breaking)
# ---------------------------------------------------------------------------


def mirror_capacity_dispatch(
    pref: np.ndarray,
    load: np.ndarray,
    capacity: int,
    n_rounds: int,
    load_factor: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Scalar mirror of the engine's dispatch scoring + capacity_dispatch.

    pref: (T,) int32 router pick per offered query (-1 = padded / invalid,
    never assigned). The engine's scores: the preferred processor costs 0,
    any other 1 + load/load_factor (hard stealing flows overflow to the
    idlest). Score gaps between processors are >= 1/load_factor while
    float epsilon is ~1e-16, and ties break on the lowest index in both
    argmins, so the numpy and torch dispatches agree exactly.

    Returns (assignment (T,), position (T,)) with -1 for unplaced.
    """
    T = pref.shape[0]
    P = load.shape[0]
    valid = pref >= 0
    scores = np.full((T, P), np.inf)
    if T:
        base = 1.0 + load[None, :] / load_factor
        scores[valid] = np.where(
            np.arange(P)[None, :] == pref[valid][:, None], 0.0, base
        )
    assignment = np.full(T, -1, np.int32)
    position = np.full(T, -1, np.int32)
    used = np.zeros(P, np.int64)
    masked = scores
    for _ in range(n_rounds):
        unassigned = assignment < 0
        choice = masked.argmin(1) if T else np.zeros(0, np.int64)
        has_choice = np.isfinite(masked.min(1)) if T else np.zeros(0, bool)
        cand = np.where(unassigned & has_choice, choice, P)
        rank = np.zeros(T, np.int64)
        for p in range(P):
            idxs = np.flatnonzero(cand == p)
            rank[idxs] = np.arange(idxs.size)
        free = capacity - used
        cand_safe = np.minimum(cand, P - 1)
        ok = unassigned & (cand < P) & (rank < free[cand_safe])
        assignment[ok] = cand[ok]
        position[ok] = used[cand_safe[ok]] + rank[ok]
        used += np.bincount(cand[ok], minlength=P + 1)[:P]
        retry = unassigned & ~ok & (cand < P)
        masked[np.flatnonzero(retry), cand[retry]] = np.inf
    return assignment, position


# ---------------------------------------------------------------------------
# Event-driven serving simulator
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SimResult:
    scheme: str
    n_queries: int
    throughput_qps: float  # cost-model derived, as are the two times
    mean_response_ms: float
    p99_response_ms: float
    cache_hits: int
    cache_misses: int
    hit_rate: float
    per_proc_queries: np.ndarray
    makespan_s: float
    stolen: int
    # differential-oracle accounting (None for the coupled baseline):
    per_proc_hits: Optional[np.ndarray] = None  # (P,) int64
    per_proc_misses: Optional[np.ndarray] = None  # (P,) int64 == storage reads
    touched_sets: Optional[List[set]] = None  # per-proc set of rows read

    def row(self) -> str:
        return (
            f"{self.scheme:>10s}  qps={self.throughput_qps:9.1f}  "
            f"resp={self.mean_response_ms:7.2f}ms  hit={self.hit_rate:6.3f}  "
            f"stolen={self.stolen}"
        )


@dataclasses.dataclass
class QueuedSimResult:
    """Round-based (continuous batching) outcome, the queue-aware half of
    the oracle. Per-query arrays follow the engine's explicit-mask
    contract: -1 wherever `completed` is False."""

    scheme: str
    n_queries: int
    n_rounds: int
    completed: np.ndarray  # (Q,) bool
    dropped: np.ndarray  # (Q,) bool -- drop-oldest admission victims
    assignment: np.ndarray  # (Q,) int32 executing processor, -1 uncompleted
    completion_round: np.ndarray  # (Q,) int32, -1 uncompleted
    wait_rounds: np.ndarray  # (Q,) int32 completion - arrival round, -1
    backlog_depth: np.ndarray  # (R,) ring depth after each round
    drops_per_round: np.ndarray  # (R,)
    offered_qids: List[List[int]]  # per round, valid offers in FIFO order
    per_proc_queries: np.ndarray  # (P,)
    per_proc_hits: np.ndarray  # (P,)
    per_proc_misses: np.ndarray  # (P,) == storage reads
    touched_sets: List[set]
    cache_hits: int
    cache_misses: int
    hit_rate: float

    def drop_set(self) -> set:
        return set(np.nonzero(self.dropped)[0].tolist())


class LRUCache:
    """The paper's per-processor LRU over adjacency rows (entries = rows)."""

    __slots__ = ("capacity", "d")

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.d: OrderedDict = OrderedDict()

    def access(self, key: int) -> bool:
        """Returns hit?; inserts on miss (evicting the LRU entry)."""
        if self.capacity <= 0:
            return False
        if key in self.d:
            self.d.move_to_end(key)
            return True
        self.d[key] = True
        if len(self.d) > self.capacity:
            self.d.popitem(last=False)
        return False


def _serve_one(cache: LRUCache, touched: np.ndarray, use_cache: bool,
               touched_set: set) -> int:
    """Reads `touched` through `cache`; returns the hits."""
    rows = touched.tolist()
    touched_set.update(rows)
    if not use_cache:
        return 0
    return sum(map(cache.access, rows))


class ServingSimulator:
    """Decoupled gRouting cluster: 1 router, P processors, S storage shards."""

    def __init__(
        self,
        g: CSRGraph,
        n_processors: int,
        router: SimRouter,
        cache_entries: int = 1 << 16,
        cost: CostModel = INFINIBAND,
        h: int = 3,
        use_cache: bool = True,
        ball_cache: Optional[BallCache] = None,
        steal: bool = True,
    ):
        self.g = g
        self.P = n_processors
        self.router = router
        self.cost = cost
        self.h = h
        self.use_cache = use_cache
        self.cache_entries = cache_entries
        self.balls = ball_cache or BallCache(g)
        self.steal = steal

    def run(
        self,
        wl: Workload,
        h: Optional[int] = None,
        assignments: Optional[np.ndarray] = None,
    ) -> SimResult:
        """Serve the workload. With `assignments` (one processor id per
        query) the router is bypassed and the simulator executes exactly
        that placement, idle stealing off, so the placement is kept as
        given: the hook the engine / simulator oracle compares the two
        paths under one route with."""
        h = h or self.h
        P = self.P
        steal = self.steal and assignments is None
        caches = [LRUCache(self.cache_entries if self.use_cache else 0) for _ in range(P)]
        queues: List[List[int]] = [[] for _ in range(P)]  # pending query indices
        load = np.zeros(P, dtype=np.float64)

        # --- dispatch phase: the router assigns the burst (ack-driven queues)
        assign = np.zeros(wl.query_nodes.size, dtype=np.int32)
        if assignments is not None:
            assign[:] = np.asarray(assignments, np.int32)
            if not ((assign >= 0).all() and (assign < P).all()):
                raise ValueError(
                    "injected assignments must place every query on a real "
                    "processor (engine runs with unplaced queries cannot be "
                    "replayed)")
            for i, p in enumerate(assign):
                queues[int(p)].append(i)
                load[int(p)] += 1.0
        else:
            for i, q in enumerate(wl.query_nodes):
                p = self.router.route(int(q), load)
                assign[i] = p
                queues[p].append(i)
                load[p] += 1.0

        # --- execution phase: event-driven, steal-on-idle; events are
        #     (time, proc) processor-free times
        events = [(0.0, p) for p in range(P)]
        heapq.heapify(events)
        resp = np.zeros(wl.query_nodes.size)
        hits = 0
        misses = 0
        stolen = 0
        done = 0
        makespan = 0.0
        per_proc = np.zeros(P, dtype=np.int64)
        per_hits = np.zeros(P, dtype=np.int64)
        per_miss = np.zeros(P, dtype=np.int64)
        touched_sets: List[set] = [set() for _ in range(P)]
        while done < wl.query_nodes.size:
            t, p = heapq.heappop(events)
            if not queues[p]:
                if not steal:
                    continue
                # steal from the longest queue (tail = farthest-future query)
                victim = int(np.argmax([len(qq) for qq in queues]))
                if not queues[victim]:
                    continue
                i = queues[victim].pop()
                load[victim] -= 1.0
                load[p] += 1.0
                stolen += 1
            else:
                i = queues[p].pop(0)
            q = int(wl.query_nodes[i])
            touched, _result = self.balls.get(q, h)
            q_hits = _serve_one(caches[p], touched, self.use_cache, touched_sets[p])
            q_miss = touched.size - q_hits
            rounds = h  # one batched multi_read per hop
            if self.use_cache:
                st = self.cost.service_time_s(touched.size, q_miss, rounds)
            else:
                st = self.cost.no_cache_time_s(touched.size, rounds)
            hits += q_hits
            misses += q_miss
            per_hits[p] += q_hits
            per_miss[p] += q_miss
            resp[i] = st
            per_proc[p] += 1
            load[p] -= 1.0
            t_done = t + st
            makespan = max(makespan, t_done)
            heapq.heappush(events, (t_done, p))
            done += 1

        total = hits + misses
        return SimResult(
            scheme=self.router.scheme if self.use_cache else "no_cache",
            n_queries=int(wl.query_nodes.size),
            throughput_qps=wl.query_nodes.size / max(makespan, 1e-12),
            mean_response_ms=float(resp.mean() * 1e3),
            p99_response_ms=float(np.percentile(resp, 99) * 1e3),
            cache_hits=int(hits),
            cache_misses=int(misses),
            hit_rate=float(hits / total) if total else 0.0,
            per_proc_queries=per_proc,
            makespan_s=float(makespan),
            stolen=stolen,
            per_proc_hits=per_hits,
            per_proc_misses=per_miss,
            touched_sets=touched_sets,
        )

    def run_rounds(
        self,
        wl: Workload,
        *,
        round_size: int,
        capacity: int,
        backlog_capacity: int,
        dispatch_rounds: int = 0,
        h: Optional[int] = None,
        route_fn=None,
        max_rounds: int = 100_000,
    ) -> QueuedSimResult:
        """Round-based continuous-batching mirror of `ServingEngine`.

        Each round offers the carry-over backlog (oldest first) ahead of
        the next `round_size` fresh arrivals, routes them, dispatches
        through `mirror_capacity_dispatch` (`capacity` slots a processor,
        hard stealing), executes the placed queries against the
        per-processor LRU caches, re-queues the leftovers FIFO and drops
        the oldest once the ring passes `backlog_capacity`. Arrival rounds
        are followed by drain rounds until the ring empties, as the
        engine's `run(..., drain=True)`.

        `route_fn(round_idx, qids, nodes, load) -> picks` injects routing
        decisions (the oracle replays the engine's recorded per-round
        router picks, as `run(assignments=...)` does); the mirror adds one
        to a processor's load per routed query, whichever path picked. The
        default is this simulator's own `SimRouter`, exact for integer
        routing (hash); for next_ready the engine's round-robin tie-break
        is not mirrored, and landmark / embed score in other float widths:
        replay those.
        """
        h = h or self.h
        P = self.P
        n_dispatch = dispatch_rounds if dispatch_rounds > 0 else P
        lf = float(self.router.cfg.load_factor)
        Q = int(wl.query_nodes.size)
        arrival_rounds = -(-Q // round_size)
        caches = [
            LRUCache(self.cache_entries if self.use_cache else 0) for _ in range(P)
        ]
        backlog: List[int] = []  # qids, FIFO oldest first
        completed = np.zeros(Q, bool)
        dropped = np.zeros(Q, bool)
        assignment = np.full(Q, -1, np.int32)
        completion_round = np.full(Q, -1, np.int32)
        wait_rounds = np.full(Q, -1, np.int32)
        backlog_depth: List[int] = []
        drops_per_round: List[int] = []
        offered_log: List[List[int]] = []
        per_proc = np.zeros(P, np.int64)
        per_hits = np.zeros(P, np.int64)
        per_miss = np.zeros(P, np.int64)
        touched_sets: List[set] = [set() for _ in range(P)]
        hits = misses = 0

        r = 0
        while r < arrival_rounds or backlog:
            if r >= max_rounds:
                raise RuntimeError("round loop failed to terminate")
            fresh = list(range(r * round_size, min((r + 1) * round_size, Q)))
            offered = backlog + fresh  # backlog first: FIFO priority
            offered_log.append(list(offered))
            nodes = wl.query_nodes[offered].astype(np.int64)

            # route (load starts at zero each round: every routed query is
            # acked -- completed, re-queued or dropped -- in the same round)
            load = np.zeros(P)
            if route_fn is not None:
                pref = np.asarray(
                    route_fn(r, np.asarray(offered), nodes, load.copy()),
                    np.int32,
                )
                if pref.shape != (len(offered),):
                    raise ValueError(f"route_fn gave {pref.shape} picks for {len(offered)}")
                for p in pref:
                    load[int(p)] += 1.0
            else:
                pref = np.zeros(len(offered), np.int32)
                for i, q in enumerate(nodes):
                    p = self.router.route(int(q), load)
                    pref[i] = p
                    load[p] += 1.0

            assign, pos = mirror_capacity_dispatch(pref, load, capacity, n_dispatch, lf)

            # execute the placed queries per processor in dispatch-slot
            # order (order matters only under contended caches)
            for p in range(P):
                mine = np.flatnonzero(assign == p)
                mine = mine[np.argsort(pos[mine], kind="stable")]
                for i in mine:
                    qid = offered[int(i)]
                    q = int(wl.query_nodes[qid])
                    touched, _result = self.balls.get(q, h)
                    q_hits = _serve_one(caches[p], touched, self.use_cache, touched_sets[p])
                    q_miss = touched.size - q_hits
                    hits += q_hits
                    misses += q_miss
                    per_hits[p] += q_hits
                    per_miss[p] += q_miss
                    per_proc[p] += 1
                    completed[qid] = True
                    assignment[qid] = p
                    completion_round[qid] = r
                    wait_rounds[qid] = r - qid // round_size

            # drop-oldest admission control on the leftovers (FIFO order)
            leftovers = [offered[i] for i in range(len(offered)) if assign[i] < 0]
            n_over = max(len(leftovers) - backlog_capacity, 0)
            for qid in leftovers[:n_over]:
                dropped[qid] = True
            backlog = leftovers[n_over:]
            backlog_depth.append(len(backlog))
            drops_per_round.append(n_over)
            r += 1

        total = hits + misses
        return QueuedSimResult(
            scheme=self.router.scheme if self.use_cache else "no_cache",
            n_queries=Q,
            n_rounds=r,
            completed=completed,
            dropped=dropped,
            assignment=assignment,
            completion_round=completion_round,
            wait_rounds=wait_rounds,
            backlog_depth=np.asarray(backlog_depth, np.int32),
            drops_per_round=np.asarray(drops_per_round, np.int32),
            offered_qids=offered_log,
            per_proc_queries=per_proc,
            per_proc_hits=per_hits,
            per_proc_misses=per_miss,
            touched_sets=touched_sets,
            cache_hits=int(hits),
            cache_misses=int(misses),
            hit_rate=float(hits / total) if total else 0.0,
        )


# ---------------------------------------------------------------------------
# Coupled-baseline simulator (SEDGE/Giraph & PowerGraph stand-in, Fig. 8)
# ---------------------------------------------------------------------------


def run_coupled_baseline(
    g: CSRGraph,
    wl: Workload,
    labels: np.ndarray,
    n_workers: int,
    h: int = 3,
    ball_cache: Optional[BallCache] = None,
    t_superstep_ms: float = 18.0,
) -> SimResult:
    """Partition-coupled BSP execution: the owner of the query node runs the
    query; every hop is a superstep; neighbours on other partitions cost
    remote accesses. Cache-less (vertex-centric engines recompute)."""
    cm = CoupledSystemModel(t_superstep_ms=t_superstep_ms)
    balls = ball_cache or BallCache(g)
    busy = np.zeros(n_workers)
    resp = np.zeros(wl.query_nodes.size)
    for i, q in enumerate(wl.query_nodes):
        w = int(labels[int(q)]) % n_workers
        touched, _ = balls.get(int(q), h)
        if touched.size:
            cut = float(np.mean(labels[touched] % n_workers != w))
        else:
            cut = 0.0
        st = cm.service_time_s(touched.size, h, cut)
        resp[i] = st
        busy[w] += st
    makespan = float(busy.max())
    return SimResult(
        scheme="coupled",
        n_queries=int(wl.query_nodes.size),
        throughput_qps=wl.query_nodes.size / max(makespan, 1e-12),
        mean_response_ms=float(resp.mean() * 1e3),
        p99_response_ms=float(np.percentile(resp, 99) * 1e3),
        cache_hits=0,
        cache_misses=int(sum(balls.get(int(q), h)[0].size for q in wl.query_nodes)),
        hit_rate=0.0,
        per_proc_queries=np.bincount(labels[wl.query_nodes] % n_workers, minlength=n_workers),
        makespan_s=makespan,
        stolen=0,
    )
