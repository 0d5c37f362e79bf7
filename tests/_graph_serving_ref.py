"""The reference's distributed serving step on 4 host devices, for
tests/test_torch_graph_serving.py: run as a program, it serves every case
of `_graph_serving_cases` through `repro.serve.graph_serving` and writes
the inputs, the outputs and the oracle's counts to one .npz.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_graph_serving_ref.py OUT.npz [PART PARTS]

With PART and PARTS it runs every PARTS-th job from the PART-th, so that
several processes can share the work.
"""

from __future__ import annotations

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

import _graph_serving_cases as C
from repro.core.embedding import EmbedConfig, GraphEmbedding
from repro.core.router import Router, RouterConfig
from repro.core.serving import hhop_ball
from repro.core.storage import build_storage, make_serving_storage
from repro.graph.csr import to_padded
from repro.graph.generators import powerlaw_graph
from repro.serve.graph_serving import (
    GServeConfig, make_admission_round, make_distributed_serve_step, make_processor_caches,
)

LEAVES = ("tags", "age", "data", "deg", "cont", "clock", "hits", "misses")


def host(tree):
    """Outputs back to the host between steps: a step's outputs carry
    shardings its inputs lacked, and would make jit compile it again."""
    return jax.tree.map(np.asarray, tree)


def mesh_of(shape) -> Mesh:
    k = shape[0] * shape[1]
    return Mesh(np.array(jax.devices()[:k]).reshape(shape), ("data", "model"))


def setup(g, adj, shape, case):
    mesh = mesh_of(shape)
    cfg = GServeConfig(**C.config(shape, case, g.n, adj.n_rows), expand_backend="scatter")
    store = make_serving_storage(build_storage(adj, n_shards=shape[1]))
    return mesh, cfg, store


def serve_steps(out, prefix, mesh, cfg, store, inp, g):
    """STEPS steps over the same queries; outputs under `prefix`."""
    step = jax.jit(make_distributed_serve_step(mesh, cfg))
    inputs = dict({k: jnp.asarray(v) for k, v in inp.items()}, **store,
                  cache=make_processor_caches(mesh, cfg))
    for k, v in inp.items():
        out[f"{prefix}/{k}"] = v
    out[f"{prefix}/oracle"] = np.array(
        [[hhop_ball(g, int(q), cfg.hops)[1] - 1 if q >= 0 else -1 for q in row]
         for row in inp["queries"]], np.int32)
    for s in range(C.STEPS):
        with mesh:
            counts, ema, cache, stats = host(step(inputs))
        inputs = dict(inputs, cache=cache, ema=ema)
        put_step(out, f"{prefix}/step{s}", counts, ema, cache, stats)


def put_step(out, prefix, counts, ema, cache, stats):
    out[f"{prefix}/counts"] = np.asarray(counts)
    out[f"{prefix}/ema"] = np.asarray(ema)
    out[f"{prefix}/stats"] = np.asarray(stats)
    for leaf in LEAVES:
        out[f"{prefix}/cache/{leaf}"] = np.asarray(cache[leaf])


def admission(out, g, adj, shape, scheme):
    mesh, cfg, store = setup(g, adj, shape, "roomy")
    P = shape[0] * shape[1]
    prefix = f"admission/{scheme}/{C.mesh_name(shape)}"
    inp = C.inputs(shape, g.n)
    emb = GraphEmbedding(coords=inp["coords"], landmarks=np.zeros(1, np.int32),
                         lm_coords=inp["coords"][:1], config=EmbedConfig(dim=C.EMBED_DIM))
    router = Router(P, RouterConfig(scheme=scheme), embedding=emb)
    rstate = host(router.init_state())
    for f in dataclasses.fields(rstate):
        out[f"{prefix}/rstate/{f.name}"] = np.asarray(getattr(rstate, f.name))
    adm_round, init_backlog = make_admission_round(router, mesh, cfg,
                                                   backlog_capacity=C.RING[shape])
    backlog = init_backlog()
    step = jax.jit(make_distributed_serve_step(mesh, cfg))
    arrivals = C.arrivals(shape)
    stream = np.random.default_rng(3).integers(0, g.n, C.BURSTS * arrivals).astype(np.int32)
    out[f"{prefix}/stream"] = stream
    inputs = dict(coords=jnp.asarray(inp["coords"]), ema=jnp.asarray(inp["ema"]), **store,
                  cache=make_processor_caches(mesh, cfg))
    out[f"{prefix}/ema"] = inp["ema"]
    out[f"{prefix}/coords"] = inp["coords"]
    r = 0
    while r < C.BURSTS or int(backlog.depth()) > 0:
        fresh = stream[r * arrivals:(r + 1) * arrivals] if r < C.BURSTS else \
            np.full(arrivals, -1, np.int32)
        qids = (r * arrivals + np.arange(arrivals)).astype(np.int32)
        qbuf, adm = host(adm_round(rstate, backlog, jnp.asarray(fresh), jnp.asarray(qids)))
        rstate, backlog = adm.rstate, adm.backlog
        rp = f"{prefix}/round{r}"
        out[f"{rp}/qbuf"] = np.asarray(qbuf)
        for name, value in adm._asdict().items():
            fields = value._asdict() if hasattr(value, "_asdict") else (
                {f.name: getattr(value, f.name) for f in dataclasses.fields(value)}
                if dataclasses.is_dataclass(value) else None)
            if fields is None:
                out[f"{rp}/adm/{name}"] = np.asarray(value)
            else:
                for k, v in fields.items():
                    out[f"{rp}/adm/{name}.{k}"] = np.asarray(v)
        with mesh:
            counts, ema, cache, stats = host(step(dict(inputs, queries=qbuf)))
        inputs = dict(inputs, cache=cache, ema=ema)
        put_step(out, rp, counts, ema, cache, stats)
        r += 1
    out[f"{prefix}/rounds"] = np.int32(r)


def jobs():
    for case in C.CASES:
        for shape in C.MESHES:
            yield ("serve", case, shape)
    yield ("sync", "roomy", C.SYNC_MESH)
    for shape, schemes in C.ADMISSION.items():
        for scheme in schemes:
            yield ("admission", scheme, shape)


def main(path, part=0, parts=1):
    g = powerlaw_graph(**C.GRAPH)
    adj = to_padded(g, max_degree=C.MAX_DEGREE)
    out = {"degree": g.degree().astype(np.int32)}
    for i, (kind, what, shape) in enumerate(jobs()):
        if i % parts != part:
            continue
        for k, v in make_serving_storage(build_storage(adj, n_shards=shape[1])).items():
            out[f"storage/{shape[1]}/{k}"] = np.asarray(v)
        if kind == "admission":
            admission(out, g, adj, shape, what)
            continue
        mesh, cfg, store = setup(g, adj, shape, what)
        inp = C.inputs(shape, g.n)
        if kind == "sync":
            inp["queries"] = C.sync_queries(g.degree())
        serve_steps(out, f"{kind if kind == 'sync' else what}/{C.mesh_name(shape)}", mesh, cfg,
                    store, inp, g)
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1], *map(int, sys.argv[2:]))
