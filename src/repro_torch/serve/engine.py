"""The end-to-end serving engine: the whole gRouting loop, round by round.

`ServingEngine.run` pushes a multi-hop query workload through serving
rounds. Each round is the paper's router -> processor -> storage pipeline:

  1. carry-over admission  -- queries parked in the bounded FIFO backlog
                              ring are re-offered AHEAD of this round's
                              fresh arrivals;
  2. `Router.route_batch`  -- sequential smart routing (Algorithms 2/4);
  3. `capacity_dispatch`   -- bounded per-round processor queues; overflow
                              is hard query stealing to the next-best
                              processor; what still does not fit goes back
                              to the ring, and when the ring overflows the
                              OLDEST waiters are dropped;
  4. `processor_round`     -- each processor expands its queries' h-hop
                              balls (`expand_hop`: set-associative cache,
                              read-combined storage reads, and the visited
                              sets marked by the CUDA frontier kernels);
  5. ack                   -- router load decremented by routed counts;
                              per-round stats are kept.

The reference runs the rounds as one `lax.scan` and the processors under
`vmap`; here rounds and processors are Python loops over device tensors,
and each processor's result is exactly what its vmapped step gives it.

Per-query outcomes come only from the explicit masks of `EngineResult`:
`completed` (the query ran; `counts[q]` is valid) and `dropped`. `counts`
keeps -1 for queries that never completed.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import cache as cache_lib
from repro_torch.core.cache import CacheState
from repro_torch.core.dispatch import (
    BacklogState, DispatchResult, backlog_admit, backlog_offer,
    capacity_dispatch, gather_by_dispatch, make_backlog, scatter_back,
)
from repro_torch.core.query_engine import EngineConfig, QueryStats, run_neighbor_aggregation
from repro_torch.core.router import Router, RouterState
from repro_torch.core.storage import StorageTier, multi_read_ref, sharded_multi_read
from repro_torch.core.workloads import Workload
from repro_torch.device import DeviceLike, resolve_device


def processor_round(
    cache: CacheState,
    queries: torch.Tensor,
    *,
    h: int,
    n: int,
    ecfg: EngineConfig,
    multi_read: Callable,
    touched_map: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, CacheState, QueryStats, Optional[torch.Tensor]]:
    """One processor serves its dispatched query batch (h-hop aggregation).

    queries: (B,) int32, -1 padded. touched_map: optional (n,) bool bitmap
    of node rows this processor has read. Returns (counts (B,), cache',
    stats, touched_map')."""
    return run_neighbor_aggregation(
        cache, queries, h=h, n=n, cfg=ecfg, multi_read=multi_read,
        touched_map=touched_map,
    )


def ema_round_update(
    ema: torch.Tensor, me: int, coords: torch.Tensor, queries: torch.Tensor, alpha: float
) -> torch.Tensor:
    """Eq. 5 applied once per round over the executed batch's mean coords.

    Returns processor `me`'s new EMA row; the caller merges it into the
    replicated (P, D) table (a summed delta on the distributed path). The
    mean divides by a (1,) tensor: CUDA divides by a Python number as a
    multiply by its reciprocal."""
    okq = (queries >= 0)[:, None]
    qc = coords[queries.clamp(min=0).long()]
    n_ok = okq.sum(dtype=torch.int32).clamp(min=1).reshape(1)
    mean_new = torch.where(okq, qc, 0.0).sum(0) / n_ok
    return alpha * ema[me] + (1.0 - alpha) * mean_new


def make_retrying_multi_read(
    local_rows: torch.Tensor,
    local_deg: torch.Tensor,
    local_cont: torch.Tensor,
    owner_lut: torch.Tensor,
    loc_lut: torch.Tensor,
    *,
    group,
    n_shards: int,
    capacity: int,
    row_width: int,
    retries: int,
) -> Callable:
    """Bounded-retry `sharded_multi_read` over the storage `group`.

    Requests dropped by the per-(proc, shard) capacity are issued again.
    Every rank runs exactly `retries` rounds of the exchange, even when
    nothing is pending anywhere: the collectives must match across the
    group, and the reference runs the same fixed count. A request still
    unserved after the last round reads as a row of -1 with deg 0 and cont
    -1, as in the reference."""

    def multi_read(ids: torch.Tensor):
        out_rows = torch.full(ids.shape + (row_width,), -1, dtype=torch.int32, device=ids.device)
        out_deg = torch.zeros(ids.shape, dtype=torch.int32, device=ids.device)
        out_cont = torch.full(ids.shape, -1, dtype=torch.int32, device=ids.device)
        pending = ids
        for _ in range(retries):
            r, d, c, served = sharded_multi_read(
                pending, local_rows, local_deg, local_cont, owner_lut, loc_lut,
                group=group, n_shards=n_shards, capacity=capacity,
            )
            out_rows = torch.where(served[:, None], r, out_rows)
            out_deg = torch.where(served, d, out_deg)
            out_cont = torch.where(served, c, out_cont)
            pending = torch.where(served, -1, pending)
        return out_rows, out_deg, out_cont

    return multi_read


class AdmissionRound(NamedTuple):
    """Everything one admission round decides (all fixed-shape)."""

    rstate: RouterState  # router state after route + ack
    backlog: BacklogState  # ring after re-queue / drop-oldest
    offered_node: torch.Tensor  # (M,) int32: backlog-first, then fresh; -1 pad
    offered_qid: torch.Tensor  # (M,) int32 global query ids, -1 pad
    r_assign: torch.Tensor  # (M,) router's pick per offered query
    dispatch: DispatchResult  # assignment/position/counts over the offer
    placed: torch.Tensor  # (M,) bool: valid AND dispatched this round
    dropped: torch.Tensor  # (M,) bool: evicted by admission control
    depth: torch.Tensor  # () int32 backlog depth after the round
    n_dropped: torch.Tensor  # () int32 drops this round
    stolen: torch.Tensor  # () int32 placed on != router pick
    unplaced: torch.Tensor  # () int32 valid but not placed this round


def admission_dispatch(
    router: Router,
    rstate: RouterState,
    backlog: BacklogState,
    fresh_node: torch.Tensor,
    fresh_qid: torch.Tensor,
    *,
    capacity: int,
    dispatch_rounds: int,
) -> AdmissionRound:
    """One admission round over `backlog ++ fresh` (backlog offered first).

    Scoring: the router's pick costs 0, every other processor 1 + its load
    term (so overflow flows to the idlest -- hard stealing). The ack
    decrements the ROUTER-chosen processor for every valid offered query,
    which is where route_batch incremented load, so neither stolen,
    re-queued nor dropped queries leak load.
    """
    P = router.P
    off_node, off_qid = backlog_offer(backlog, fresh_node, fresh_qid)
    valid = off_node >= 0
    rstate, r_assign = router.route_batch(rstate, off_node)
    onehot = torch.arange(P, device=off_node.device)[None, :] == r_assign[:, None]
    load_term = router.load_term(rstate.load)[None, :]
    scores = torch.where(onehot, 0.0, 1.0 + load_term)
    scores = torch.where(valid[:, None], scores, torch.inf)
    d = capacity_dispatch(scores, capacity=capacity, n_rounds=dispatch_rounds)
    placed = valid & (d.assignment >= 0)
    routed = torch.bincount(torch.where(valid, r_assign, P).long(),
                            minlength=P + 1)[:P].to(torch.float32)
    rstate = dataclasses.replace(rstate, load=rstate.load - routed)
    leftover = valid & ~placed
    backlog, dropped, depth, n_dropped = backlog_admit(
        off_node, off_qid, leftover, backlog.capacity
    )
    return AdmissionRound(
        rstate=rstate,
        backlog=backlog,
        offered_node=off_node,
        offered_qid=off_qid,
        r_assign=r_assign,
        dispatch=d,
        placed=placed,
        dropped=dropped,
        depth=depth,
        n_dropped=n_dropped,
        stolen=(placed & (d.assignment != r_assign)).sum(dtype=torch.int32),
        unplaced=leftover.sum(dtype=torch.int32),
    )


@dataclasses.dataclass(frozen=True)
class EngineRunConfig:
    n_processors: int
    round_size: int = 32  # B: fresh arrivals admitted per serving round
    capacity: int = 0  # C: per-processor slots per round (0 -> round_size)
    hops: int = 2
    max_frontier: int = 256
    cache_sets: int = 512
    cache_ways: int = 4
    chain_depth: int = 8
    steal_rounds: int = 0  # dispatch passes (0 -> n_processors)
    use_cache: bool = True
    # frontier-expansion backend (core.visited.EXPAND_BACKENDS)
    expand_backend: str = "cuda"
    # visited-set layout (core.visited.VISITED_LAYOUTS)
    visited_layout: str = "dense"
    # K: carry-over admission queue slots (0 = overflow dropped at once)
    backlog_capacity: int = 0
    # keep per-processor touch bitmaps (n bools each) for differential checks
    track_touched: bool = False

    @property
    def slot_capacity(self) -> int:
        return self.capacity if self.capacity > 0 else self.round_size

    @property
    def dispatch_rounds(self) -> int:
        return self.steal_rounds if self.steal_rounds > 0 else self.n_processors


@dataclasses.dataclass
class EngineResult:
    """Host-side summary of one ServingEngine.run (all numpy).

    `completed[q]` gates every per-query field -- `counts`, `assignment`,
    `router_assignment`, `completion_round` and `wait_rounds` hold -1 where
    it is False. Never infer completion from `counts == -1` alone.
    """

    scheme: str
    n_queries: int
    counts: np.ndarray  # (Q,) per-query |N_h(q)| - 1; -1 where not completed
    completed: np.ndarray  # (Q,) bool -- query was placed and executed
    dropped: np.ndarray  # (Q,) bool -- evicted by drop-oldest admission
    completion_round: np.ndarray  # (Q,) int32 round the query executed; -1
    wait_rounds: np.ndarray  # (Q,) int32 completion - arrival round; -1
    assignment: np.ndarray  # (Q,) executed processor per query (post-steal)
    router_assignment: np.ndarray  # (Q,) router's pick in the executing round
    per_proc_queries: np.ndarray  # (P,)
    per_proc_touched: np.ndarray  # (P,)
    per_proc_reads: np.ndarray  # (P,) unique storage rows fetched
    touched: int
    reads: int
    probe_misses: int
    stolen: int
    unplaced: int  # valid queries never executed (= dropped + left in ring)
    n_dropped: int  # admission-control drops
    final_backlog: int  # ring depth at return (0 when drain=True)
    peak_backlog: int  # max per-round ring depth
    mean_wait_rounds: float  # mean latency-in-rounds over completed queries
    truncated: bool
    hit_rate: float  # (touched - reads) / touched
    load_imbalance: float  # max/mean of per_proc_queries
    wall_s: float
    throughput_qps: float  # COMPLETED queries per second
    touched_bitmap: Optional[np.ndarray]  # (P, n) bool rows this proc read
    per_round: dict  # per-round arrays: touched, reads, stolen, per_proc, ...


class QueueCarry(NamedTuple):
    """The backlog ring plus lifetime counters (they keep growing across
    warm-state reuse; `run()` reports per-run deltas and checks them against
    its reconstruction from the per-round offer logs)."""

    backlog: BacklogState
    completed: torch.Tensor  # () int32 queries executed so far
    dropped: torch.Tensor  # () int32 admission-control drops so far
    wait_sum: torch.Tensor  # () int32 sum of completed queries' wait rounds
    peak_depth: torch.Tensor  # () int32 max backlog depth seen


def _unstack(caches: CacheState, P: int) -> List[CacheState]:
    fields = [f.name for f in dataclasses.fields(CacheState)]
    return [CacheState(**{k: getattr(caches, k)[p] for k in fields}) for p in range(P)]


def _stack(caches: List[CacheState]) -> CacheState:
    fields = [f.name for f in dataclasses.fields(CacheState)]
    return CacheState(**{k: torch.stack([getattr(c, k) for c in caches]) for k in fields})


def _check(cond: bool, msg) -> None:
    if not cond:
        raise RuntimeError(f"engine self-check failed: {msg}")


class ServingEngine:
    """Single-host end-to-end engine over decoupled storage, on `device`.

    Storage access defaults to the single-device `multi_read_ref`; pass
    `multi_read` to substitute another reader. The tier and router must
    live on the engine's device.
    """

    def __init__(
        self,
        tier: StorageTier,
        router: Router,
        cfg: EngineRunConfig,
        multi_read: Optional[Callable] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        if router.P != cfg.n_processors:
            raise ValueError(f"router has {router.P} processors, config {cfg.n_processors}")
        if tier.device != self.device or router.device != self.device:
            raise ValueError(f"tier on {tier.device}, router on {router.device}, "
                             f"engine on {self.device}")
        self.tier = tier
        self.router = router
        self.cfg = cfg
        self.n = tier.n
        self._multi_read = multi_read or (lambda ids: multi_read_ref(tier, ids))
        self._ecfg = EngineConfig(
            max_frontier=cfg.max_frontier,
            chain_depth=cfg.chain_depth,
            use_cache=cfg.use_cache,
            expand_backend=cfg.expand_backend,
            visited_layout=cfg.visited_layout,
        )

    # -- state ---------------------------------------------------------------

    def init_caches(self) -> CacheState:
        """Stacked per-processor caches: every field gains a leading (P,) axis."""
        one = cache_lib.make_cache(self.cfg.cache_sets, self.cfg.cache_ways,
                                   self.tier.row_width, device=self.device)
        return _stack([one] * self.cfg.n_processors)

    def init_touched(self) -> Optional[torch.Tensor]:
        if not self.cfg.track_touched:
            return None
        return torch.zeros((self.cfg.n_processors, self.n), dtype=torch.bool,
                           device=self.device)

    def init_queue(self) -> QueueCarry:
        z = torch.zeros((), dtype=torch.int32, device=self.device)
        return QueueCarry(
            backlog=make_backlog(self.cfg.backlog_capacity, device=self.device),
            completed=z, dropped=z, wait_sum=z, peak_depth=z,
        )

    # -- one round -------------------------------------------------------------

    def _round(self, rstate, caches: List[CacheState], tmaps, qc: QueueCarry,
               fresh_node: torch.Tensor, fresh_qid: torch.Tensor, round_idx: int):
        cfg = self.cfg
        P, C, B = cfg.n_processors, cfg.slot_capacity, cfg.round_size

        # 1+2. carry-over admission: backlog re-offered ahead of the fresh
        #      arrivals, routed, dispatched (hard stealing), leftovers
        #      re-queued with drop-oldest admission control
        adm = admission_dispatch(
            self.router, rstate, qc.backlog, fresh_node, fresh_qid,
            capacity=C, dispatch_rounds=cfg.dispatch_rounds,
        )
        d = adm.dispatch
        qbuf = gather_by_dispatch(adm.offered_node, d, P, C, fill_value=-1)

        # 3. every processor serves its slice
        counts_p, stats_p = [], []
        for p in range(P):
            counts, caches[p], stats, tm = processor_round(
                caches[p], qbuf[p], h=cfg.hops, n=self.n, ecfg=self._ecfg,
                multi_read=self._multi_read,
                touched_map=None if tmaps is None else tmaps[p],
            )
            if tmaps is not None:
                tmaps[p] = tm
            counts_p.append(counts)
            stats_p.append(stats)
        counts = scatter_back(torch.stack(counts_p), d, adm.offered_node.shape[0])
        # unplaced (and padded) queries must not masquerade as |N_h(q)|-1 == 0
        counts = torch.where(adm.placed, counts, -1)

        # 4. latency-in-rounds: arrival round is qid // B by construction
        waited = torch.where(adm.placed, round_idx - adm.offered_qid // B, 0)
        qc = QueueCarry(
            backlog=adm.backlog,
            completed=qc.completed + adm.placed.sum(dtype=torch.int32),
            dropped=qc.dropped + adm.n_dropped,
            wait_sum=qc.wait_sum + waited.sum(dtype=torch.int32),
            peak_depth=torch.maximum(qc.peak_depth, adm.depth),
        )
        ys = {
            "offered_qid": adm.offered_qid,
            "counts": counts,
            "assignment": torch.where(adm.placed, d.assignment, -1),
            "router_assignment": adm.r_assign,
            "placed": adm.placed,
            "dropped": adm.dropped,
            "per_proc": d.counts,  # executed per processor (post-steal)
            "touched": torch.stack([s.touched for s in stats_p]),
            "reads": torch.stack([s.reads for s in stats_p]),
            "probe_misses": torch.stack([s.misses for s in stats_p]),
            "truncated": torch.stack([s.truncated.any() for s in stats_p]),
            "stolen": adm.stolen,
            "unplaced": adm.unplaced,
            "backlog_depth": adm.depth,
            "n_dropped": adm.n_dropped,
        }
        return adm.rstate, qc, ys

    # -- host entry ----------------------------------------------------------

    def run(
        self, wl: Workload, state=None, drain: bool = True
    ) -> Tuple[EngineResult, tuple]:
        """Serve a workload; returns (result, final (rstate, caches, tmap, qc)).

        Pass the returned state back in to serve a follow-up burst against
        warm caches. With `drain=True` (default) the engine appends
        arrival-free rounds, in chunks, until the backlog ring is empty, so
        every admitted query either completes or is dropped -- required
        before reusing the state on a new workload, because backlog entries
        hold query ids relative to THIS run. The given state is not modified.
        """
        cfg = self.cfg
        P, C, K = cfg.n_processors, cfg.slot_capacity, cfg.backlog_capacity
        Q = int(wl.query_nodes.size)
        B = cfg.round_size
        R = -(-Q // B)
        dev = self.device
        padded = np.full(R * B, -1, np.int32)
        padded[:Q] = wl.query_nodes

        if state is None:
            state = (self.router.init_state(), self.init_caches(),
                     self.init_touched(), self.init_queue())
        rstate, caches, tmap, qc = state
        q0 = qc  # counter baseline: carry totals are lifetime values
        if int(q0.backlog.depth()) != 0:
            raise ValueError(
                "reused state carries an undrained backlog: its query ids refer "
                "to the PREVIOUS workload; finish it with drain=True first")
        caches = _unstack(caches, P)
        tmaps = None if tmap is None else list(tmap.unbind(0))
        nodes = torch.from_numpy(padded).to(dev).view(R, B)
        qids = torch.arange(R * B, dtype=torch.int32, device=dev).view(R, B)

        t0 = time.perf_counter()
        ys_rounds = []
        for r in range(R):
            rstate, qc, ys = self._round(rstate, caches, tmaps, qc, nodes[r], qids[r], r)
            ys_rounds.append(ys)
        n_rounds = R
        if drain and K > 0:
            # drain in chunks of D rounds; every round with a non-empty ring
            # places >= 1 query, so <= K extra rounds suffice
            D = max(1, -(-K // max(1, P * C)))
            empty = torch.full((B,), -1, dtype=torch.int32, device=dev)
            for _ in range(K + 1):
                if int(qc.backlog.depth()) == 0:
                    break
                for j in range(D):
                    rstate, qc, ys = self._round(
                        rstate, caches, tmaps, qc, empty,
                        R * B + j * B + torch.arange(B, dtype=torch.int32, device=dev),
                        n_rounds + j)
                    ys_rounds.append(ys)
                n_rounds += D
            _check(int(qc.backlog.depth()) == 0, "backlog failed to drain")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        ys = {k: torch.stack([y[k] for y in ys_rounds]).cpu().numpy()
              for k in ys_rounds[0]}

        # -- reconstruct per-query outcomes from the per-round offer logs ----
        counts = np.full(Q, -1, np.int32)
        assign = np.full(Q, -1, np.int32)
        r_assign = np.full(Q, -1, np.int32)
        completion_round = np.full(Q, -1, np.int32)
        wait_rounds = np.full(Q, -1, np.int32)
        completed = np.zeros(Q, bool)
        dropped = np.zeros(Q, bool)
        qid_f = ys["offered_qid"].reshape(-1)
        round_f = np.repeat(np.arange(n_rounds, dtype=np.int32),
                            ys["offered_qid"].shape[1])
        placed_f = ys["placed"].reshape(-1) & (qid_f >= 0) & (qid_f < Q)
        idx = qid_f[placed_f]
        _check(idx.size == np.unique(idx).size, "query executed twice")
        counts[idx] = ys["counts"].reshape(-1)[placed_f]
        assign[idx] = ys["assignment"].reshape(-1)[placed_f]
        r_assign[idx] = ys["router_assignment"].reshape(-1)[placed_f]
        completion_round[idx] = round_f[placed_f]
        wait_rounds[idx] = round_f[placed_f] - idx // B
        completed[idx] = True
        dropped_f = ys["dropped"].reshape(-1) & (qid_f >= 0) & (qid_f < Q)
        dropped[qid_f[dropped_f]] = True

        per_proc = ys["per_proc"].sum(0)
        touched_p = ys["touched"].sum(0)
        reads_p = ys["reads"].sum(0)
        touched = int(touched_p.sum())
        reads = int(reads_p.sum())
        n_completed = int(completed.sum())

        # the in-carry counters (this run's deltas) are authoritative; the
        # offer-log reconstruction above must agree with them
        carry_completed = int(qc.completed) - int(q0.completed)
        carry_dropped = int(qc.dropped) - int(q0.dropped)
        carry_wait = int(qc.wait_sum) - int(q0.wait_sum)
        _check(carry_completed == n_completed, (carry_completed, n_completed))
        _check(carry_dropped == int(dropped.sum()), (carry_dropped, dropped.sum()))
        _check(carry_wait == int(wait_rounds[completed].sum()), "wait rounds")
        peak_backlog = int(ys["backlog_depth"].max(initial=0))
        _check(int(qc.peak_depth) >= peak_backlog, "peak backlog")
        tmap = None if tmaps is None else torch.stack(tmaps)
        result = EngineResult(
            scheme=self.router.scheme,
            n_queries=Q,
            counts=counts,
            completed=completed,
            dropped=dropped,
            completion_round=completion_round,
            wait_rounds=wait_rounds,
            assignment=assign,
            router_assignment=r_assign,
            per_proc_queries=per_proc,
            per_proc_touched=touched_p,
            per_proc_reads=reads_p,
            touched=touched,
            reads=reads,
            probe_misses=int(ys["probe_misses"].sum()),
            stolen=int(ys["stolen"].sum()),
            unplaced=Q - n_completed,
            n_dropped=carry_dropped,
            final_backlog=int(qc.backlog.depth()),
            peak_backlog=peak_backlog,
            mean_wait_rounds=carry_wait / n_completed if n_completed else 0.0,
            truncated=bool(ys["truncated"].any()),
            hit_rate=float((touched - reads) / touched) if touched else 0.0,
            load_imbalance=float(per_proc.max() / max(per_proc.mean(), 1e-9)),
            wall_s=wall,
            throughput_qps=n_completed / max(wall, 1e-9),
            touched_bitmap=None if tmap is None else tmap.cpu().numpy(),
            per_round=ys,
        )
        return result, (rstate, _stack(caches), tmap, qc)
