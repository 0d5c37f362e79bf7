"""grouting: the paper's own system at WebGraph-class storage shapes.

The distributed serving step (`serve/graph_serving.py`): every rank is a
query processor with a set-associative LRU cache; the adjacency rows are
the decoupled storage tier, sharded over the mesh's "model" axis; the
multi_read is an all_to_all (Figure 2 on a process mesh). Three shapes
bracket the paper's workloads, each served with the 2-hop hotspot stream:

  serve_hot_3hop  -- the headline cell (2-hop hotspot, 3-hop traversal class)
  serve_1hop      -- 1-hop traversal (cache-neutral per the paper's Fig 18a)
  serve_bulk      -- large per-processor query batches (throughput mode)

4,194,304 nodes at 32-wide rows; the paper's WebGraph has 106 M nodes.
One round's dense visited state is B x 4,194,304 bytes (67 MB at B = 16,
268 MB at B = 64), the packed words an eighth of that. A power-law graph
of this size at degree 8 pads to about 4.65 M rows, inside `N_ROWS`.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchDef, Cell, DryRunSpec, merged_rules
from repro_torch.distributed.mesh import n_processors
from repro_torch.distributed.mesh_utils import mesh_axes
from repro_torch.serve.graph_serving import GServeConfig, abstract_serve_inputs

G_RULES = {"storage": "model", "proc": "data"}

# why the dry run does not count the step: it runs on live tensors
NOT_COUNTED = ("the serving step reads the device once a chain link (the trip count "
               "of its continuation loop), which meta tensors cannot answer")

N_NODES = 1 << 22
ROW_WIDTH = 32
N_ROWS = int(N_NODES * 1.25)  # + continuation rows for power-law hubs

SHAPES = {
    "serve_hot_3hop": dict(kind="serve", hops=3, qpp=16, max_frontier=2048),
    "serve_1hop": dict(kind="serve", hops=1, qpp=64, max_frontier=256),
    "serve_bulk": dict(kind="serve", hops=2, qpp=64, max_frontier=1024),
}


def model_cfg(shape: str = "serve_hot_3hop") -> GServeConfig:
    d = SHAPES[shape]
    return GServeConfig(
        n_nodes=N_NODES,
        n_rows=N_ROWS,
        row_width=ROW_WIDTH,
        n_storage_shards=16,  # the "model" axis' size
        queries_per_proc=d["qpp"],
        hops=d["hops"],
        max_frontier=d["max_frontier"],
        cache_sets=2048,
        cache_ways=4,
        read_capacity=d["max_frontier"] * 2,
        chain_depth=8,
    )


def smoke_cfg() -> GServeConfig:
    return GServeConfig(
        n_nodes=512, n_rows=640, row_width=8, n_storage_shards=1,
        queries_per_proc=4, hops=2, max_frontier=64, cache_sets=64,
        cache_ways=2, read_capacity=256, chain_depth=4,
    )


def build_dryrun(shape: str, mesh) -> DryRunSpec:
    """One processor's inputs as `meta` tensors and the reference's flops
    proxy. The port's inputs are one rank's own (`abstract_serve_inputs`):
    queries and cache of its processor, its storage shard's rows, the
    routing tables replicated; so one spec, (), covers every leaf, whose
    bytes are the device's. The storage shards are the mesh's "model" axis."""
    axes = mesh_axes(mesh)
    cfg = dataclasses.replace(model_cfg(shape), n_storage_shards=int(axes["model"]))
    rows_per_shard = -(-cfg.n_rows // cfg.n_storage_shards)
    inputs = abstract_serve_inputs(mesh, cfg, rows_per_shard)
    n_proc = n_processors(mesh)
    # MODEL_FLOPS proxy: rows touched x row width compares per hop
    touched = n_proc * cfg.queries_per_proc * cfg.max_frontier * cfg.hops
    return DryRunSpec(
        fn=None,
        args=(inputs,),
        in_specs=((),),  # a prefix: every leaf is the device's own
        rules=merged_rules(G_RULES),
        meta={"params": 0, "tokens": n_proc * cfg.queries_per_proc,
              "model_flops": float(touched * cfg.row_width), "kind": "serve",
              "not_counted": NOT_COUNTED},
    )


ARCH = ArchDef(
    name="grouting",
    family="grouting",
    cells=tuple(Cell(shape=s, kind=d["kind"], rules=G_RULES) for s, d in SHAPES.items()),
    model_cfg=model_cfg,
    smoke_cfg=smoke_cfg,
    build_dryrun=build_dryrun,
)
