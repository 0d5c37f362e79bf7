"""Multi-process helpers for the port's distributed tests: `spawn` runs a
function in gloo ranks on the CPU, and the workers below drive
`repro_torch.serve.graph_serving` over the cases of
`_graph_serving_cases`. Spawned children import this module by name, so it
imports torch and the port only (no JAX), and its workers are module-level
functions.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import queue
import time
import traceback
from types import SimpleNamespace
from typing import Callable, List

import numpy as np
import torch
import torch.distributed as dist

import _graph_serving_cases as C
from repro_torch import convert
from repro_torch.core.cache import CacheState
from repro_torch.core.embedding import EmbedConfig, GraphEmbedding
from repro_torch.core.router import Router, RouterConfig
from repro_torch.core.storage import sharded_feature_gather, stripe_rows
from repro_torch.distributed.mesh import init_mesh, n_processors
from repro_torch.serve.graph_serving import (
    GServeConfig, make_admission_round, make_distributed_serve_step, make_processor_caches,
)

LAYOUTS = ("dense", "packed")
BACKENDS = ("scatter", "cuda")  # "cuda" takes the kernels' plain versions on the CPU
LEAVES = tuple(f.name for f in dataclasses.fields(CacheState))


def _child(fn, rank, world, args, out):
    try:
        torch.set_num_threads(1)
        out.put((rank, fn(rank, world, *args), None))
    except BaseException:  # reported to the parent, which raises
        out.put((rank, None, traceback.format_exc()))


def spawn(fn: Callable, world: int, *args, timeout: float = 300.0) -> List:
    """fn(rank, world, *args) in `world` spawned processes; returns the
    results by rank. A child's exception, or no result within `timeout`
    seconds (a hung collective), fails the call; every child is stopped."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_child, args=(fn, r, world, args, out), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results, done = [None] * world, False
    deadline = time.monotonic() + timeout
    try:
        for _ in range(world):
            while True:
                try:
                    rank, res, err = out.get(timeout=1.0)
                    break
                except queue.Empty:
                    dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                    if dead:  # died before it could report (e.g. at import)
                        raise RuntimeError(f"{fn.__name__}: a rank exited with {dead[0]}")
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{fn.__name__}: no result from every rank in {timeout} s")
            if err:  # the other ranks may wait on it in a collective: stop them
                raise RuntimeError(f"{fn.__name__}, rank {rank}:\n{err}")
            results[rank] = res
        done = True
    finally:
        for p in procs:
            if not done:
                p.kill()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return results


def _store(store_dir, name, world):
    return dist.FileStore(os.path.join(store_dir, name), world)


def _numpy(counts, ema, cache, stats) -> dict:
    """A step's outputs as numpy copies (later steps may reuse the memory)."""
    out = {"counts": counts, "ema": ema, "stats": stats}
    out.update({f"cache/{k}": getattr(cache, k) for k in LEAVES})
    return {k: v.numpy().copy() for k, v in out.items()}


def _steps(mesh, cfg, inputs) -> list:
    step = make_distributed_serve_step(mesh, cfg)
    outs = []
    for _ in range(C.STEPS):
        counts, ema, cache, stats = step(inputs)
        inputs = dict(inputs, cache=cache, ema=ema)
        outs.append(_numpy(counts, ema, cache, stats))
    return outs


def _serve_inputs(ref, prefix, mesh, rank):
    """This rank's slice of the reference's inputs under `prefix`: its
    storage shard, its queries (where the case has them), the coordinates
    and the EMA."""
    S = mesh.shape["model"]
    ins = {k: ref[f"storage/{S}/{k}"] for k in ("rows", "deg", "cont", "owner", "loc")}
    ins.update({k: ref[f"{prefix}/{k}"] for k in ("queries", "coords", "ema")
                if f"{prefix}/{k}" in ref})
    return convert.serve_inputs(ins, proc=rank, shard=mesh.axis_index("model"), device="cpu")


def _admission(ref, mesh, rank, scheme, layout, n, n_rows) -> dict:
    """The reference's admission run on the port: rank 0 routes, the buffer
    goes to every rank, each serves its row."""
    shape = (mesh.shape["data"], mesh.shape["model"])
    prefix = f"admission/{scheme}/{C.mesh_name(shape)}"
    P = shape[0] * shape[1]
    cfg = GServeConfig(**C.config(shape, "roomy", n, n_rows), visited_layout=layout)
    ins = _serve_inputs(ref, prefix, mesh, rank)
    ins["cache"] = make_processor_caches(mesh, cfg, "cpu")
    step = make_distributed_serve_step(mesh, cfg)
    if rank == 0:
        coords = ref[f"{prefix}/coords"]
        emb = GraphEmbedding(coords=coords, landmarks=np.zeros(1, np.int32),
                             lm_coords=coords[:1], config=EmbedConfig(dim=C.EMBED_DIM))
        router = Router(P, RouterConfig(scheme=scheme), embedding=emb, device="cpu")
        rstate = convert.router_state(SimpleNamespace(
            **{k: ref[f"{prefix}/rstate/{k}"] for k in ("load", "ema", "rr")}), "cpu")
        adm_round, init_backlog = make_admission_round(router, mesh, cfg, C.RING[shape])
        backlog = init_backlog()
    stream = ref[f"{prefix}/stream"]
    arrivals = C.arrivals(shape)
    rounds = []
    for r in range(int(ref[f"{prefix}/rounds"])):
        qbuf = torch.empty((P, C.QPP), dtype=torch.int32)
        res = {}
        if rank == 0:
            fresh = stream[r * arrivals:(r + 1) * arrivals] if r < C.BURSTS else \
                np.full(arrivals, -1, np.int32)
            qids = torch.arange(r * arrivals, (r + 1) * arrivals, dtype=torch.int32)
            qbuf, adm = adm_round(rstate, backlog, torch.from_numpy(fresh), qids)
            rstate, backlog = adm.rstate, adm.backlog
            res = {f"adm/{k}": v for k, v in _flatten(adm).items()}
            res["qbuf"] = qbuf.numpy()
        dist.broadcast(qbuf, src=0)
        counts, ema, cache, stats = step(dict(ins, queries=qbuf[rank]))
        ins = dict(ins, cache=cache, ema=ema)
        res.update(_numpy(counts, ema, cache, stats))
        rounds.append(res)
    return {"rounds": rounds}


def _flatten(adm) -> dict:
    """An AdmissionRound's fields as numpy, nested ones as `name.field`."""
    out = {}
    for name, value in adm._asdict().items():
        if isinstance(value, torch.Tensor):
            out[name] = value.numpy()
        else:
            for k, v in convert.fields_to_numpy(value).items():
                out[f"{name}.{k}"] = v
    return out


def serve_all(rank: int, world: int, store_dir: str, ref_paths: List[str]) -> dict:
    """Every case of `_graph_serving_cases` on this rank, mesh by mesh (a
    process group each); returns {case key: this rank's outputs}."""
    ref = {}
    for path in ref_paths:
        with np.load(path) as z:
            ref.update({k: z[k] for k in z.files})
    n = int(ref["degree"].shape[0])
    n_rows = int(ref["storage/1/owner"].shape[0])
    out = {}
    for shape in C.MESHES:  # SYNC_MESH and the admission meshes among them
        size = shape[0] * shape[1]
        if rank >= size:
            continue
        mesh, _ = init_mesh(shape, ("data", "model"), "cpu",
                            store=_store(store_dir, C.mesh_name(shape), size),
                            rank=rank, world_size=size)
        name = C.mesh_name(shape)
        out[f"mesh/{name}"] = {
            "coords": {a: mesh.axis_index(a) for a in mesh.axes},
            "groups": {a: dist.get_process_group_ranks(mesh.group(a)) for a in mesh.axes},
        }
        for layout in LAYOUTS:
            for backend in BACKENDS:
                tail = f"{name}/{layout}/{backend}"
                for case in list(C.CASES) + (["sync"] if shape == C.SYNC_MESH else []):
                    cfg = GServeConfig(**C.config(shape, "roomy" if case == "sync" else case,
                                                  n, n_rows),
                                       expand_backend=backend, visited_layout=layout)
                    ins = _serve_inputs(ref, f"{case}/{name}", mesh, rank)
                    ins["cache"] = make_processor_caches(mesh, cfg, "cpu")
                    out[f"{case}/{tail}"] = _steps(mesh, cfg, ins)
            for scheme in C.ADMISSION.get(shape, ()):
                out[f"admission/{scheme}/{name}/{layout}"] = _admission(
                    ref, mesh, rank, scheme, layout, n, n_rows)
        if shape[1] > 1:
            out[f"gather/{name}"] = _feature_gather(mesh, rank)
        dist.destroy_process_group()
    return out


def _feature_gather(mesh, rank) -> dict:
    """`sharded_feature_gather` over rows striped by `stripe_rows`, with a
    budget that makes some requests overflow."""
    S = mesh.shape["model"]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((50, 3)).astype(np.float32)
    local = torch.from_numpy(stripe_rows(x, S)).view(S, -1, 3)[mesh.axis_index("model")]
    ids = rng.integers(-1, 50, (n_processors(mesh), 24)).astype(np.int32)[rank]
    feat, served = sharded_feature_gather(torch.from_numpy(ids), local, mesh.group("model"),
                                          S, capacity=4)
    return {"x": x, "ids": ids, "feat": feat.numpy(), "served": served.numpy()}


def bursts_graph(n: int):
    """The graph of `serve_bursts_all`: a community graph with hubs whose
    rows need continuation rows."""
    from repro_torch.graph.generators import community_graph

    return community_graph(n=n, community_size=64, intra_degree=4, seed=0)


def serve_bursts_all(rank: int, world: int, store_dir: str) -> dict:
    """`launch/serve_graph.py` `serve_bursts` on (data, model) (2, 2): the
    grouting smoke config over two storage shards, 48 queries routed by the
    embed router on rank 0, with `record`. Returns this rank's figures and
    record."""
    from repro_torch.configs import grouting
    from repro_torch.core.storage import build_storage, make_serving_storage
    from repro_torch.graph.csr import to_padded
    from repro_torch.launch.serve_graph import serve_bursts

    cfg = dataclasses.replace(grouting.smoke_cfg(), n_storage_shards=2, embed_dim=4)
    g = bursts_graph(cfg.n_nodes)
    tier = build_storage(to_padded(g, max_degree=cfg.row_width), n_shards=2, device="cpu")
    rng = np.random.default_rng(1)
    emb = GraphEmbedding(coords=rng.standard_normal((g.n, 4)).astype(np.float32),
                         landmarks=np.arange(4), lm_coords=np.zeros((4, 4), np.float32),
                         config=EmbedConfig(dim=4))
    nodes = rng.integers(0, g.n, 48).astype(np.int32)
    mesh, dev = init_mesh((2, 2), ("data", "model"), "cpu",
                          store=_store(store_dir, "bursts", world), rank=rank, world_size=world)
    res = serve_bursts(mesh, dev, cfg, make_serving_storage(tier, mesh.axis_index("model"), dev),
                       emb if rank == 0 else None, nodes if rank == 0 else None, bursts=3,
                       backlog=16, say=lambda *a, **k: None, record=True)
    del res["cache"]
    dist.destroy_process_group()
    return res
