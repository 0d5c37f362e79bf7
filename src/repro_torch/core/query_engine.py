"""Batched h-hop query engine (paper Algorithm 5).

Fixed-shape state per processor batch, as in the reference package:

  frontier      (B, F) int32   padded -1 (F = max frontier width)
  visited       the resultSet bitmap, one row per query, in the layout
                `EngineConfig.visited_layout` selects (`core.visited`)
  cache         CacheState     shared by the whole processor (as in paper)

Per hop (one iteration of Algorithm 5's while loop):
  1. probe the cache for all frontier rows                (lines 6-12)
  2. multi_read the misses from storage, insert to cache  (lines 17-27)
  3. follow continuation chains (bounded by `chain_depth`)
  4. mark neighbours in `visited` through the expansion backend (the CUDA
     kernels by default); next frontier = the newly visited nodes, the
     first F of them in ascending id order, overflow recorded in
     `truncated`.

The chain loop is a Python loop: whether another link is needed is read
on the host once per iteration (one device sync each). The next frontier
is built from a cumsum rank and a scatter, so its shape stays fixed and
no `nonzero` sync is needed.

The paper's three query types (§2.2): h-hop neighbour aggregation (the
serving path), h-step random walk with restart and h-hop reachability (a
bi-directional BFS through `expand_hop`, so through the same kernels).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import cache as cache_lib
from repro_torch.core.cache import CacheState
from repro_torch.core.storage import StorageTier, multi_read_ref
from repro_torch.core.visited import get_visited_layout
from repro_torch.kernels.ref import in_range, mark


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_frontier: int = 2048  # F
    chain_depth: int = 64  # cap on continuation-row links chased per hop
    use_cache: bool = True
    # how step 4 runs: "scatter" (plain PyTorch reference), "cuda" (the
    # kernels) or "auto" (the kernel; see core.visited). Semantics are
    # backend-invariant.
    expand_backend: str = "cuda"
    # "dense" ((B, n) bool) | "packed" ((B, ceil(n/32)) words); semantics
    # are layout-invariant
    visited_layout: str = "dense"
    # the process group whose ranks must run the same number of chain links
    # (their multi_read holds collectives): each link's decision is then the
    # group's all_reduce(MAX) of the flag. None: this process decides alone.
    sync: Optional[dist.ProcessGroup] = None


class HopResult(NamedTuple):
    visited: torch.Tensor  # per-query visited set in the configured layout
    frontier: torch.Tensor  # (B, F) int32
    cache: CacheState
    truncated: torch.Tensor  # (B,) bool -- frontier overflow or chain cut
    reads: torch.Tensor  # () int32 -- unique storage rows fetched
    touched: torch.Tensor  # () int32 -- rows needed (hits + misses)
    probe_misses: torch.Tensor  # () int32 -- missed cache probes (incl. dups)


def _dedup_first(ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Intra-batch duplicate detection for read combining.

    ids: (M,) int32. Returns (first (M,) bool -- entry is the first
    occurrence of its value; src (M,) int64 -- index of that first
    occurrence, identity for first occurrences).
    """
    M = ids.shape[0]
    dev = ids.device
    if M == 0:
        return (torch.zeros(0, dtype=torch.bool, device=dev),
                torch.zeros(0, dtype=torch.int64, device=dev))
    s, order = torch.sort(ids, stable=True)
    is_first_s = torch.ones(M, dtype=torch.bool, device=dev)
    is_first_s[1:] = s[1:] != s[:-1]
    pos = torch.arange(M, device=dev)
    head_pos_s = torch.cummax(torch.where(is_first_s, pos, 0), dim=0).values
    first = torch.empty(M, dtype=torch.bool, device=dev)
    first[order] = is_first_s
    src = torch.empty(M, dtype=torch.int64, device=dev)
    src[order] = order[head_pos_s]
    return first, src


def _read_rows(
    cache_state: CacheState,
    ids: torch.Tensor,
    use_cache: bool,
    multi_read: Callable,
):
    """Cache-first row read with intra-batch read combining.

    ids: (M,) int32 (-1 padded). A row id requested more than once in the
    batch is fetched from storage once and inserted into the cache once;
    later duplicates are served from the first fetch.

    Returns (rows, deg, cont, cache', n_probe_miss, n_reads, n_touch).
    """
    valid = ids >= 0
    n_touch = valid.sum(dtype=torch.int32)
    if not use_cache:
        first, src = _dedup_first(torch.where(valid, ids, -1))
        uniq = valid & first
        rows, deg, cont = multi_read(torch.where(uniq, ids, -1))
        n_reads = uniq.sum(dtype=torch.int32)
        return rows[src], deg[src], cont[src], cache_state, n_touch, n_reads, n_touch
    found, c_rows, c_deg, c_cont, cache_state = cache_lib.cache_lookup(
        cache_state, ids, valid
    )
    miss = valid & ~found
    first, src = _dedup_first(torch.where(miss, ids, -1))
    uniq = miss & first
    fetch_ids = torch.where(uniq, ids, -1)
    s_rows, s_deg, s_cont = multi_read(fetch_ids)
    # duplicates of a missed id read the first occurrence's fetched row
    s_rows, s_deg, s_cont = s_rows[src], s_deg[src], s_cont[src]
    cache_state = cache_lib.cache_insert(
        cache_state, fetch_ids, s_rows, s_deg, s_cont, valid=uniq
    )
    rows = torch.where(found[:, None], c_rows, s_rows)
    deg = torch.where(found, c_deg, s_deg)
    cont = torch.where(found, c_cont, s_cont)
    return (rows, deg, cont, cache_state, miss.sum(dtype=torch.int32),
            uniq.sum(dtype=torch.int32), n_touch)


def _any(flag: torch.Tensor, group: Optional[dist.ProcessGroup]) -> bool:
    """`flag` (a () bool) on the host; with a group, true when it is true on
    any of the group's ranks (one all_reduce, still one host sync)."""
    if group is None:
        return bool(flag)
    f = flag.to(torch.int32).reshape(1)
    dist.all_reduce(f, op=dist.ReduceOp.MAX, group=group)
    return bool(f.item())


def _first_f(newly: torch.Tensor, F: int) -> torch.Tensor:
    """(B, n) bool -> (B, F) int32: the first F set ids of each row in
    ascending order, -1 padded (a fixed-shape `nonzero`)."""
    B, n = newly.shape
    rank = newly.cumsum(dim=1) - 1
    slot = torch.where(newly & (rank < F), rank, F)  # column F is a dump
    ids = torch.arange(n, dtype=torch.int32, device=newly.device).expand(B, n)
    out = torch.full((B, F + 1), -1, dtype=torch.int32, device=newly.device)
    return out.scatter_(1, slot, ids)[:, :F].contiguous()


def expand_hop(
    cache_state: CacheState,
    visited: torch.Tensor,
    frontier: torch.Tensor,
    cfg: EngineConfig,
    multi_read: Callable,
    n: int,
) -> HopResult:
    """One BFS hop for a batch of queries sharing one processor cache.
    `visited` is not modified; the hop's marks go into a clone of it."""
    B, F = frontier.shape
    W = cache_state.row_width
    layout = get_visited_layout(cfg.visited_layout)
    expand_fn = layout.expander(cfg.expand_backend, n)

    zero = torch.zeros((), dtype=torch.int32, device=frontier.device)
    reads, touched, probes = zero, zero, zero
    # the chain carries visited | this hop's marks; the backends update it
    # in place, so it starts from a clone (`visited` is needed below)
    new_mask = visited.clone()
    ids = frontier.reshape(-1)
    go = _any((ids >= 0).any(), cfg.sync)
    it = 0
    while go and it < cfg.chain_depth:
        rows, deg, cont, cache_state, n_probe_miss, n_reads, n_touch = _read_rows(
            cache_state, ids, cfg.use_cache, multi_read
        )
        reads, touched, probes = reads + n_reads, touched + n_touch, probes + n_probe_miss
        new_mask = expand_fn(rows.view(B, F, W), deg.view(B, F), new_mask)
        # continuation rows (hubs whose adjacency spans several rows) are
        # drained in the same hop, as in Algorithm 5's per-hop multi_read
        ids = cont
        go = _any((ids >= 0).any(), cfg.sync)
        it += 1

    newly_dense = layout.to_dense(layout.minus(new_mask, visited), n)
    nxt = _first_f(newly_dense, F)
    # truncated if the frontier overflowed F, OR the continuation chain was
    # cut off by the chain_depth cap while rows still had continuations
    truncated = (newly_dense.sum(dim=1) > F) | go
    return HopResult(new_mask, nxt, cache_state, truncated, reads, touched, probes)


@dataclasses.dataclass
class QueryStats:
    """Per-batch execution statistics.

    `misses` counts missed cache probes (duplicates within one probe each
    count); `reads` counts unique rows fetched from storage after
    intra-batch read combining.

    `truncated_fwd`/`truncated_bwd` are set only by `run_reachability` (each
    direction of its bi-directional BFS; `truncated` is their OR); every
    other query type leaves them None.
    """

    touched: torch.Tensor  # rows needed across hops (hits+misses)
    misses: torch.Tensor  # missed cache probes
    result_sizes: torch.Tensor  # (B,) |N_h(q)|
    truncated: torch.Tensor  # (B,) bool
    reads: torch.Tensor  # unique storage rows fetched
    truncated_fwd: Optional[torch.Tensor] = None  # (B,) bool, reachability only
    truncated_bwd: Optional[torch.Tensor] = None  # (B,) bool, reachability only


def run_neighbor_aggregation(
    cache_state: CacheState,
    queries: torch.Tensor,
    h: int,
    n: int,
    cfg: EngineConfig,
    multi_read: Callable,
    touched_map: Optional[torch.Tensor] = None,
):
    """h-hop Neighbor Aggregation: count nodes within h hops of each query.

    queries: (B,) int32. Returns (counts (B,), cache', stats, touched_map').
    When `touched_map` (an (n,) bool bitmap) is given, the frontier's node
    rows are ORed into it before each hop (continuation rows >= n are not
    tracked); otherwise the fourth value is None.
    """
    B = queries.shape[0]
    layout = get_visited_layout(cfg.visited_layout)
    visited, frontier, valid_q = layout.init_search(queries, n, cfg.max_frontier)

    zero = torch.zeros((), dtype=torch.int32, device=queries.device)
    misses, reads, touched = zero, zero, zero
    truncated = torch.zeros(B, dtype=torch.bool, device=queries.device)
    for _ in range(h):
        if touched_map is not None:
            ids = frontier.reshape(-1)
            touched_map = touched_map | mark(ids, in_range(ids, n), n)
        res = expand_hop(cache_state, visited, frontier, cfg, multi_read, n)
        visited, frontier, cache_state = res.visited, res.frontier, res.cache
        misses = misses + res.probe_misses
        reads = reads + res.reads
        touched = touched + res.touched
        truncated = truncated | res.truncated

    sizes = layout.count(visited)
    counts = sizes - valid_q.to(torch.int32)  # exclude the query node
    stats = QueryStats(
        touched=touched, misses=misses, result_sizes=sizes,
        truncated=truncated, reads=reads,
    )
    return counts, cache_state, stats, touched_map


Draw = Callable[[int, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def uniform_draw(generator: torch.Generator, restart_prob: float = 0.15) -> Draw:
    """The random walk's default draws, from `generator` on its own device:
    draw(step, deg) -> (pick, restart), pick uniform in [0, max(deg, 1)),
    restart where a uniform u < restart_prob. The results move to deg's
    device, so one CPU generator gives the same walk on any device."""

    def draw(step: int, deg: torch.Tensor):
        B = deg.shape[0]
        high = torch.clamp(deg.to(generator.device, torch.int64), min=1)
        u = torch.rand(B, generator=generator, device=generator.device, dtype=torch.float64)
        pick = torch.minimum((u * high).floor().to(torch.int64), high - 1)
        restart = torch.rand(B, generator=generator, device=generator.device) < restart_prob
        return pick.to(deg.device), restart.to(deg.device)

    return draw


def run_random_walk(
    cache_state: CacheState,
    queries: torch.Tensor,
    h: int,
    n: int,
    cfg: EngineConfig,
    multi_read: Callable,
    draw: Draw,
) -> Tuple[torch.Tensor, CacheState, QueryStats]:
    """h-step Random Walk with Restart. Returns the final node per query.

    Each step's pick depends on the degrees the walk has reached, so the
    draws come from `draw(step, deg) -> (pick (B,) int, restart (B,) bool)`
    at each step, which also holds the restart probability: for example
    `uniform_draw(generator, restart_prob)`. (The reference splits a
    jax.random key three ways a step; its parity test passes a draw that
    replays that chain.)
    """
    B = queries.shape[0]
    cur = queries
    zero = torch.zeros((), dtype=torch.int32, device=queries.device)
    misses, reads, touched = zero, zero, zero
    for step in range(h):
        rows, deg, cont, cache_state, n_miss, n_reads, n_touch = _read_rows(
            cache_state, cur, cfg.use_cache, multi_read
        )
        misses, reads, touched = misses + n_miss, reads + n_reads, touched + n_touch
        # a uniform neighbour of the first row (the value array is the
        # neighbour set; a hub's continuation rows are reached on later
        # steps through the chain row ids themselves)
        pick, restart = draw(step, deg)
        nxt = rows[torch.arange(B, device=rows.device), pick.long()]
        nxt = torch.where(deg > 0, nxt, cur)  # dangling: stay
        cur = torch.where(restart, queries, nxt)
        cur = torch.where(queries >= 0, cur, -1)
    stats = QueryStats(
        touched=touched, misses=misses,
        result_sizes=torch.full((B,), h + 1, dtype=torch.int32, device=queries.device),
        truncated=torch.zeros(B, dtype=torch.bool, device=queries.device), reads=reads,
    )
    return cur, cache_state, stats


def run_reachability(
    cache_state: CacheState,
    sources: torch.Tensor,
    targets: torch.Tensor,
    h: int,
    n: int,
    cfg: EngineConfig,
    multi_read: Callable,
) -> Tuple[torch.Tensor, CacheState, QueryStats]:
    """h-hop Reachability by bi-directional BFS: (h + 1) // 2 hops forward
    from the source, the rest backward from the target (the stored graph is
    bi-directed, so one adjacency serves both). Returns reachable (B,) bool;
    `result_sizes` counts the union of both visited sets."""
    B = sources.shape[0]
    layout = get_visited_layout(cfg.visited_layout)
    h_fwd = (h + 1) // 2

    def bfs(starts, hops, cache_state):
        visited, frontier, _ = layout.init_search(starts, n, cfg.max_frontier)
        zero = torch.zeros((), dtype=torch.int32, device=starts.device)
        m, r, t = zero, zero, zero
        tr = torch.zeros(B, dtype=torch.bool, device=starts.device)
        for _ in range(hops):
            res = expand_hop(cache_state, visited, frontier, cfg, multi_read, n)
            visited, frontier, cache_state = res.visited, res.frontier, res.cache
            m, r, t, tr = (m + res.probe_misses, r + res.reads,
                           t + res.touched, tr | res.truncated)
        return visited, cache_state, m, r, t, tr

    vis_f, cache_state, m1, r1, t1, tr1 = bfs(sources, h_fwd, cache_state)
    vis_b, cache_state, m2, r2, t2, tr2 = bfs(targets, h - h_fwd, cache_state)
    stats = QueryStats(
        touched=t1 + t2, misses=m1 + m2,
        result_sizes=layout.count(layout.union(vis_f, vis_b)),
        truncated=tr1 | tr2, reads=r1 + r2, truncated_fwd=tr1, truncated_bwd=tr2,
    )
    return layout.overlap_any(vis_f, vis_b), cache_state, stats


def make_ref_multi_read(tier: StorageTier) -> Callable:
    """Bind the single-device storage read."""
    return functools.partial(multi_read_ref, tier)
