"""Distributed gRouting serving step over torch.distributed.

A thin mesh wrapper over the engine step that `ServingEngine` runs
(`repro_torch.serve.engine.processor_round`): the per-processor serving
logic (h-hop BFS with a set-associative cache and storage multi_read,
stats, EMA) is shared with the single-host engine; this module adds only
the mesh concerns: the sharded multi_read binding and the summed merges.

The paper's cluster (Figure 2) on a process mesh (`distributed.mesh`):

  router state     : replicated (EMA coords per processor); the EMA update
                     (Eq. 5) is merged by an all_reduce over the world
  query processors : every rank (all mesh axes flattened); each owns a
                     set-associative LRU cache on its device
  storage tier     : adjacency rows sharded over "model" (the storage axis)
                     and replicated across "data" / "pod" (independent read
                     replicas, paper §4.4); multi_read = all_to_all over
                     the rank's "model" group

One serve step, on every rank at once:
  1. the processor runs the engine step over its query batch with its
     cache, fetching misses through the sharded multi_read; the chain loop
     agrees on its trip count over the storage group (`EngineConfig.sync`);
  2. its EMA row is updated from the executed queries (Eq. 5) and the
     deltas are summed over the world, so every rank holds the table;
  3. outputs: its per-query neighbour counts and the global [touched,
     probe misses, storage reads] stats (Eq. 8).

Routing happens outside the step: `make_admission_round` is the same
backlog-first route / dispatch / drop-oldest round the single-host engine
runs (`serve.engine.admission_dispatch`), emitting the
(n_proc, queries_per_proc) buffer. One router serves the cluster, as in
the paper: a caller runs it on one rank and broadcasts the buffer, and
each rank serves its own row.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import cache as cache_lib
from repro_torch.core.cache import CacheState
from repro_torch.core.dispatch import BacklogState, gather_by_dispatch, make_backlog
from repro_torch.core.query_engine import EngineConfig
from repro_torch.core.router import Router, RouterState
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.mesh import ProcessMesh, n_processors
from repro_torch.serve.engine import (
    AdmissionRound, admission_dispatch, ema_round_update, make_retrying_multi_read,
    processor_round,
)

STORAGE_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class GServeConfig:
    n_nodes: int  # graph nodes (visited-set width)
    n_rows: int  # storage rows (incl. continuation rows)
    row_width: int  # padded adjacency width
    n_storage_shards: int  # == the "model" axis size
    queries_per_proc: int  # query batch of one processor
    hops: int = 2
    max_frontier: int = 256
    cache_sets: int = 512
    cache_ways: int = 4
    read_capacity: int = 4096  # per-(proc, shard) multi_read budget
    read_retry: int = 4  # fixed rounds of the exchange for over-capacity requests
    chain_depth: int = 64  # cap on continuation links a hop
    # frontier-expansion backend of the engine step (core.visited)
    expand_backend: str = "cuda"
    # visited-set layout of the engine step: "dense" | "packed"
    visited_layout: str = "dense"
    embed_dim: int = 10
    alpha: float = 0.5


def make_distributed_serve_step(mesh: ProcessMesh, cfg: GServeConfig) -> Callable:
    """Returns serve_step(inputs) -> (counts (Q,), ema (P, D), cache, stats (3,))
    for this rank, where `inputs` is laid out as `abstract_serve_inputs`:
    this rank's queries, storage shard and cache, the replicated tables.
    Every rank of the mesh calls it at once (it runs collectives)."""
    if mesh.shape.get(STORAGE_AXIS) != cfg.n_storage_shards:
        raise ValueError(f"{cfg.n_storage_shards} storage shards on a mesh {mesh.shape}")
    storage = mesh.group(STORAGE_AXIS)
    ecfg = EngineConfig(
        max_frontier=cfg.max_frontier, chain_depth=cfg.chain_depth,
        expand_backend=cfg.expand_backend, visited_layout=cfg.visited_layout,
        sync=storage,
    )
    me = mesh.rank  # the processor index: row-major over the mesh axes

    def serve_step(inputs: dict):
        q = inputs["queries"]
        multi_read = make_retrying_multi_read(
            inputs["rows"], inputs["deg"], inputs["cont"], inputs["owner"], inputs["loc"],
            group=storage, n_shards=cfg.n_storage_shards, capacity=cfg.read_capacity,
            row_width=cfg.row_width, retries=cfg.read_retry,
        )
        counts, cache, stats, _ = processor_round(
            inputs["cache"], q, h=cfg.hops, n=cfg.n_nodes, ecfg=ecfg, multi_read=multi_read)
        ema = inputs["ema"]
        # Eq. 5: this processor's row moves; the others' deltas are zero, so
        # the world's sum is exact in any order. Stats ride in the same sum.
        delta = torch.zeros_like(ema)
        delta[me] = ema_round_update(ema, me, inputs["coords"], q, cfg.alpha) - ema[me]
        local_stats = torch.stack([stats.touched, stats.misses, stats.reads]).to(torch.float32)
        merged = torch.cat([delta.reshape(-1), local_stats])
        dist.all_reduce(merged, op=dist.ReduceOp.SUM, group=mesh.group())
        new_ema = ema + merged[:-3].view_as(ema)
        return counts, new_ema, cache, merged[-3:]

    return serve_step


def make_admission_round(router: Router, mesh: ProcessMesh, cfg: GServeConfig,
                         backlog_capacity: int):
    """The admission driver of the distributed step.

    Returns (admission_round, init_backlog): `admission_round(rstate,
    backlog, fresh_node, fresh_qid)` runs ONE carry-over admission round
    (backlog re-offered ahead of fresh arrivals, routing, bounded dispatch
    with hard stealing, drop-oldest re-queue) and buckets the placed
    queries into the (n_proc, queries_per_proc) buffer that
    `make_distributed_serve_step` serves row by row. It runs on the
    router's device, on one rank; it holds no collective."""
    n_proc = n_processors(mesh)
    if router.P != n_proc:
        raise ValueError(f"router of {router.P} processors on a mesh of {n_proc}")

    def admission_round(rstate: RouterState, backlog: BacklogState, fresh_node: torch.Tensor,
                        fresh_qid: torch.Tensor) -> Tuple[torch.Tensor, AdmissionRound]:
        adm = admission_dispatch(
            router, rstate, backlog, fresh_node, fresh_qid,
            capacity=cfg.queries_per_proc, dispatch_rounds=n_proc,
        )
        qbuf = gather_by_dispatch(adm.offered_node, adm.dispatch, n_proc,
                                  cfg.queries_per_proc, fill_value=-1)
        return qbuf, adm

    return admission_round, lambda: make_backlog(backlog_capacity, device=router.device)


def make_processor_caches(mesh: ProcessMesh, cfg: GServeConfig,
                          device: DeviceLike = None) -> CacheState:
    """This rank's processor cache, empty."""
    return cache_lib.make_cache(cfg.cache_sets, cfg.cache_ways, cfg.row_width,
                                device=resolve_device(device))


def abstract_serve_inputs(mesh: ProcessMesh, cfg: GServeConfig, rows_per_shard: int) -> dict:
    """This rank's inputs of the serve step as `meta` tensors (shapes and
    dtypes, no memory): what a configuration's bytes are reckoned from."""
    P, W = n_processors(mesh), cfg.row_width
    sw = (cfg.cache_sets, cfg.cache_ways)

    def meta(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    return {
        "queries": meta((cfg.queries_per_proc,)),
        "rows": meta((rows_per_shard, W)),
        "deg": meta((rows_per_shard,)),
        "cont": meta((rows_per_shard,)),
        "owner": meta((cfg.n_rows,)),
        "loc": meta((cfg.n_rows,)),
        "coords": meta((cfg.n_nodes, cfg.embed_dim), torch.float32),
        "ema": meta((P, cfg.embed_dim), torch.float32),
        "cache": CacheState(tags=meta(sw), age=meta(sw), data=meta(sw + (W,)), deg=meta(sw),
                            cont=meta(sw), clock=meta(()), hits=meta(()), misses=meta(())),
    }
