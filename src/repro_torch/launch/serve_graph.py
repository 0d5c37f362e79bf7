"""Batched graph-query serving on the distributed path: one query
processor a rank, the storage tier sharded over the mesh's "model" axis.

Each rank runs the serving step of `repro_torch.serve.graph_serving`
(set-associative cache, batched h-hop BFS of Algorithm 5, multi_read
through the sharded storage tier) over query batches routed by the embed
router, and rank 0 prints the cache hit rate of each burst as the caches
warm.

The request stream is oversubscribed: each burst brings 1.5x the
processors' slots. The overflow waits in the bounded admission backlog
(`make_admission_round`: the same route -> dispatch -> drop-oldest round
the single-host engine runs), and once arrivals stop the backlog drains
through arrival-free bursts. The router is one router, on rank 0, which
broadcasts each burst's (n_proc, queries_per_proc) buffer.

    PYTHONPATH=src python -m repro_torch.launch.serve_graph [--bursts 8] \\
        [--backend scatter|cuda|auto] [--visited-layout dense|packed] \\
        [--device cuda|cpu] [--mesh D,S]
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve_graph --mesh 2,2

Without torchrun's environment it runs as a world of one. `--mesh D,S`
lays the world out as D data x S storage ranks (default: world x 1). On a
CUDA device the ranks talk over NCCL, on the CPU over gloo. Results do not
depend on `--backend` or `--visited-layout`.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.embedding import EmbedConfig, build_graph_embedding
from repro_torch.core.landmarks import build_landmark_index
from repro_torch.core.router import Router, RouterConfig
from repro_torch.core.storage import build_storage, make_serving_storage
from repro_torch.core.visited import visited_nbytes
from repro_torch.core.workloads import hotspot_workload
from repro_torch.distributed.mesh import init_mesh, n_processors
from repro_torch.graph.csr import to_padded
from repro_torch.graph.generators import powerlaw_graph
from repro_torch.serve.graph_serving import (
    GServeConfig, make_admission_round, make_distributed_serve_step, make_processor_caches,
)

QUERIES_PER_PROC = 32
EMBED = EmbedConfig(dim=8, lm_steps=200, node_steps=80)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bursts", type=int, default=8)
    ap.add_argument("--nodes", type=int, default=4000)
    ap.add_argument("--hops", type=int, default=2)
    ap.add_argument("--backlog", type=int, default=64)
    ap.add_argument("--backend", default="cuda", choices=["scatter", "cuda", "auto"],
                    help="frontier-expansion backend: the CUDA kernels (plain versions "
                         "on the CPU) or the plain scatter")
    ap.add_argument("--visited-layout", default="dense", choices=["dense", "packed"],
                    help="visited-set representation: dense (B, n) bool vs bit-packed "
                         "(B, ceil(n/32)) words (8x smaller)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--mesh", default=None,
                    help="D,S: data x storage ranks (default: the world x 1)")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    """Serve the bursts; returns this rank's `serve_bursts` figures (rank
    0's hold the admission totals: arrivals, served, dropped, the backlog
    left), per burst the touched rows and missed probes of the whole mesh."""
    args = parse_args(argv)
    if args.mesh:
        shape = tuple(int(x) for x in args.mesh.split(","))
    else:
        shape = (int(os.environ.get("WORLD_SIZE", 1)), 1)
    mesh, dev = init_mesh(shape, ("data", "model"), args.device)
    try:
        return serve(args, mesh, dev)
    finally:
        dist.destroy_process_group()


def serve(args, mesh, dev) -> dict:
    lead = mesh.rank == 0
    say = print if lead else (lambda *_a, **_k: None)
    P, S = n_processors(mesh), mesh.shape["model"]
    g = powerlaw_graph(n=args.nodes, m=6, seed=0)
    adj = to_padded(g, max_degree=16)
    tier = build_storage(adj, n_shards=S, device="cpu")
    say(f"graph: {g.n} nodes; storage rows {adj.n_rows} (incl. {adj.n_rows - g.n} "
        f"continuation rows) in {S} shard(s); {P} processor(s) on {dev}")

    qpp = QUERIES_PER_PROC
    arrivals = P * qpp + P * qpp // 2  # 1.5x oversubscription per burst
    cfg = GServeConfig(
        n_nodes=g.n, n_rows=adj.n_rows, row_width=adj.max_degree, n_storage_shards=S,
        queries_per_proc=qpp, hops=args.hops, max_frontier=1024, cache_sets=2048,
        cache_ways=4, read_capacity=4096, chain_depth=8, expand_backend=args.backend,
        visited_layout=args.visited_layout, embed_dim=EMBED.dim,
    )
    say(f"expansion backend: {args.backend}; visited layout: {args.visited_layout} "
        f"({visited_nbytes(args.visited_layout, qpp, g.n)} bytes/round of per-query "
        f"visited state)")
    emb = nodes = None
    if lead:  # the router's embedding, and the request stream
        li = build_landmark_index(g, n_processors=P, n_landmarks=24, device=dev)
        emb = build_graph_embedding(li.dist_to_lm, li.landmarks, EMBED, device=dev)
        nodes = hotspot_workload(g, r=1, n_hotspots=6, queries_per_hotspot=arrivals,
                                 seed=1).query_nodes
    storage = make_serving_storage(tier, mesh.axis_index("model"), dev)
    return serve_bursts(mesh, dev, cfg, storage, emb, nodes, bursts=args.bursts,
                        backlog=args.backlog, say=say)


def serve_bursts(mesh, dev, cfg: GServeConfig, storage: dict, emb, nodes, *, bursts: int,
                 backlog: int, say=print, on_step=None, record: bool = False) -> dict:
    """The burst loop: each burst brings 1.5x the processors' slots of
    `nodes` (in order, wrapping around), admitted by one embed router on
    rank 0 on the coordinates of `emb`, its buffer broadcast; after
    `bursts` bursts the backlog drains. `emb` and `nodes` are read on rank 0
    only; every rank serves its row of the buffer from `storage`, its own
    shard of a tier of `cfg.n_storage_shards` shards on `dev` (as
    `core.storage.make_serving_storage` gives it), through the distributed
    step.

    Returns this rank's figures: per burst the touched rows and missed
    probes of the whole mesh and the wall seconds of this rank (from
    admission to the stats read back); with `record`, also its own
    (queries, counts, stats) of each burst as numpy ("record") and its
    final cache ("cache"). Rank 0's also hold the admission totals:
    arrivals, served, dropped, the backlog left and the queries placed a
    burst ("served_per_burst"). `on_step(b, fn)`, when given, runs burst
    b's step `fn` (a profile, say)."""
    lead = mesh.rank == 0
    P, qpp = n_processors(mesh), cfg.queries_per_proc
    arrivals = P * qpp + P * qpp // 2  # 1.5x oversubscription per burst
    step = make_distributed_serve_step(mesh, cfg)

    # one router, on rank 0: its embedding's coordinates go to every rank
    # (the EMA update reads them)
    coords = torch.empty((cfg.n_nodes, cfg.embed_dim), dtype=torch.float32, device=dev)
    if lead:
        coords.copy_(torch.from_numpy(emb.coords))
        router = Router(P, RouterConfig(scheme="embed"), embedding=emb, device=dev)
        rstate = router.init_state()
        admission, init_backlog = make_admission_round(
            router, mesh, cfg, backlog_capacity=backlog)
        ring = init_backlog()
    dist.broadcast(coords, src=0)

    inputs = dict(storage, coords=coords,
                  ema=torch.zeros((P, cfg.embed_dim), dtype=torch.float32, device=dev),
                  cache=make_processor_caches(mesh, cfg, dev))
    say(f"{'burst':>5s} {'arrive':>7s} {'served':>7s} {'backlog':>8s} {'dropped':>8s} "
        f"{'touched':>8s} {'misses':>8s} {'hit%':>6s}")
    out = dict(touched=[], misses=[], burst_s=[])
    if lead:
        out.update(arrivals=0, served=0, dropped=0, backlog=0, served_per_burst=[])
    if record:
        out["record"] = []
    no_fresh = np.full(arrivals, -1, np.int32)
    # what rank 0 sends each burst: [stop flag, the (P, qpp) buffer]
    msg = torch.empty(1 + P * qpp, dtype=torch.int32, device=dev)
    b = 0
    while True:
        t0 = time.perf_counter()
        if lead:
            draining = b >= bursts
            stop = draining and int(ring.depth()) == 0
            if not stop:
                if draining:
                    q = no_fresh  # arrivals stopped: drain the backlog
                else:
                    q = nodes[(b * arrivals) % nodes.size:][:arrivals]
                    if q.size < arrivals:
                        q = np.resize(q, arrivals)
                qids = torch.arange(b * arrivals, (b + 1) * arrivals, dtype=torch.int32,
                                    device=dev)
                qbuf, adm = admission(rstate, ring, torch.from_numpy(q).to(dev), qids)
                rstate, ring = adm.rstate, adm.backlog
                msg[1:] = qbuf.reshape(-1)
            msg[0] = int(stop)
        dist.broadcast(msg, src=0)
        if int(msg[0]):
            break
        ins = dict(inputs, queries=msg[1:].view(P, qpp)[mesh.rank])
        counts, ema, cache, stats = (step(ins) if on_step is None
                                     else on_step(b, lambda: step(ins)))
        inputs["cache"], inputs["ema"] = cache, ema
        touched, missed, _reads = stats.tolist()  # the whole mesh's, this burst
        wall = time.perf_counter() - t0
        if record:
            # copies: on the CPU .numpy() would share the reused message buffer
            out["record"].append(tuple(x.cpu().numpy().copy()
                                       for x in (ins["queries"], counts, stats)))
        out["touched"].append(int(touched))
        out["misses"].append(int(missed))
        out["burst_s"].append(wall)
        if lead:
            served, n_dropped = int(adm.placed.sum()), int(adm.n_dropped)
            out["arrivals"] += 0 if draining else arrivals
            out["served"] += served
            out["dropped"] += n_dropped
            out["served_per_burst"].append(served)
            hit = 100 * (1 - missed / max(touched, 1))
            say(f"{b:5d} {0 if draining else arrivals:7d} {served:7d} {int(adm.depth):8d} "
                f"{n_dropped:8d} {int(touched):8d} {int(missed):8d} {hit:6.1f}")
        b += 1
    if record:
        out["cache"] = inputs["cache"]
    if lead:
        out["backlog"] = int(ring.depth())
        say(f"\nserved {out['served']}, dropped {out['dropped']} (drop-oldest admission, "
            f"backlog {backlog})")
    return out


if __name__ == "__main__":
    main()
