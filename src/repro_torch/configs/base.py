"""Config registry substrate (the reference's `configs/base.py`): cells,
dry-run specs, the logical sharding rules and the per-family builders.

Every assigned architecture is a module in this package exposing ``ARCH``
(an `ArchDef`). A cell = (architecture x input shape); ``build_dryrun``
returns what `launch/dryrun.py` needs to plan that cell on a mesh: the
port's step function, its arguments as `meta` tensors (shapes and dtypes,
no memory), the sharding spec trees (`distributed.mesh_utils`), the rules
and the reference's `meta` keys (params, tokens, seq, n_groups, kind,
model_flops). The dry run counts the step's flops and bytes by running it
eagerly on the meta tensors at full depth (`analysis/roofline.py`).

Given a `ProcessMesh` (the dry run builds one over a `fake` process group
of the mesh's size), the sharded cells' steps run per rank, with rank 0's
own arguments: the LM's training step, prefill and decode step on the mesh
(`models/transformer.py` `MeshLayout`), ogb_products' full-graph step
(`models/gnn/distributed.py`) and DIN's four cells (`models/recsys/din.py`
`MeshLayout`, in `configs/din.py`); `meta["per_rank"]` says so. Given a mesh
that is only a shape (`launch.mesh.MeshShape`), every step runs as on one
device.

The graph shapes (`GNN_SHAPES`) are all synthetic (`graph/generators.py`,
`data/graphs.py`): full_graph_sm has Cora's shape, minibatch_lg Reddit's
with GraphSAGE's fanout, ogb_products ogbn-products' (distributed in the
reference), and molecule is a batch of 128 small molecular graphs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.distributed.mesh_utils import DEFAULT_RULES, resolve_pspec, set_mesh_rules
from repro_torch.models.param import abstract_params, param_count, param_pspecs

def per_rank_mesh(mesh) -> bool:
    """Whether `mesh` is a `ProcessMesh` (axis groups to run a rank's step
    over), not only a shape."""
    return hasattr(mesh, "group")


@dataclasses.dataclass(frozen=True)
class Cell:
    shape: str  # e.g. "train_4k"
    kind: str  # train | prefill | decode | serve | retrieval
    skip: Optional[str] = None  # reason this cell does not run for the arch
    rules: Optional[Dict[str, Any]] = None  # logical-rule overrides
    meta: Optional[Dict[str, Any]] = None


@dataclasses.dataclass
class DryRunSpec:
    """What the dry run counts: `fn(*args)` on meta tensors.

    `in_specs` are the arguments' sharding specs, tree by tree, over
    `state` (default: `args`): the same arguments in the layout the specs
    describe (an LM's parameters stacked per pattern index, as the
    reference's, where `fn` takes them per layer). `fn` is None where the
    step cannot run on meta tensors; `meta["not_counted"]` then says why."""

    fn: Optional[Callable]
    args: tuple
    in_specs: tuple
    rules: Dict[str, Any]
    meta: Dict[str, Any]
    state: Optional[tuple] = None
    donate: tuple = ()  # argnums updated in place (decode: the KV cache)


@dataclasses.dataclass
class ArchDef:
    name: str
    family: str  # lm | gnn | recsys | grouting
    cells: Tuple[Cell, ...]
    model_cfg: Callable[[], Any]  # full-size config
    smoke_cfg: Callable[[], Any]  # reduced config for CPU smoke tests
    build_dryrun: Callable[..., DryRunSpec]  # (shape_name, mesh)

    def cell(self, shape: str) -> Cell:
        for c in self.cells:
            if c.shape == shape:
                return c
        raise KeyError(f"{self.name}: unknown shape {shape}")


def merged_rules(overrides: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    r = dict(DEFAULT_RULES)
    if overrides:
        r.update(overrides)
    return r


def meta_tensor(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_step_fn(loss_fn: Callable, opt_cfg, schedule: bool = False, mesh=None, specs=None):
    """The reference dry run's train step over the port's pieces: the
    gradients of one microbatch (`accum_value_and_grad`), AdamW in place,
    the step advanced; with `schedule` the learning rate is
    `warmup_cosine(step, lr, 100, 10_000)`. With a mesh and the parameters'
    specs, one rank's step: the global norm over the shards.
    No host read: meta tensors have no values."""
    from repro_torch.optim.adamw import adamw_update, global_norm
    from repro_torch.optim.schedule import warmup_cosine
    from repro_torch.train.train_step import TrainState, accum_value_and_grad

    vg = accum_value_and_grad(loss_fn, 1)

    def train_step(st, b):
        (loss, metrics), grads = vg(st.params, b)
        lr = warmup_cosine(st.step, opt_cfg.lr, 100, 10_000) if schedule else None
        gn = global_norm(grads, specs, mesh) if mesh is not None else None
        _, _, om = adamw_update(grads, st.opt_state, st.params, opt_cfg, lr=lr, gn=gn)
        return TrainState(st.params, st.opt_state, st.step + 1), dict(metrics, loss=loss, **om)

    return train_step


def abstract_train_state(ap, pspecs, per_layer: Optional[Callable] = None, local=None):
    """(the state `train_step_fn` takes, the same state as `ap`'s layout,
    its specs): the parameters as trainable meta tensors (`per_layer` maps
    `ap` to the step's layout; `local`, if given, maps that to a rank's
    shards), AdamW's m and v, the step."""
    from repro_torch.optim.adamw import abstract_opt_state, adamw_init, opt_state_pspecs
    from repro_torch.train.train_step import TrainState, trainable

    params = per_layer(ap) if per_layer else ap
    params = trainable(local(params) if local else params)
    step = meta_tensor(())
    state = TrainState(params, adamw_init(params), step)
    layout = TrainState(ap, abstract_opt_state(ap), step)
    return state, layout, TrainState(pspecs, opt_state_pspecs(pspecs), ())


# ---------------------------------------------------------------------------
# LM family builder
# ---------------------------------------------------------------------------

LM_TRAIN_RULES = {
    "batch": ("pod", "data"),
    "embed": "data",  # FSDP: parameters/optimizer sharded over data
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",
}

LM_DECODE_RULES = dict(
    LM_TRAIN_RULES,
    **{"kv_seq": "model", "kv_heads": None},  # sequence-parallel KV cache
)

LM_LONG_DECODE_RULES = dict(
    LM_TRAIN_RULES,
    **{"batch": None, "kv_seq": ("data", "model"), "kv_heads": None},
)

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256, rules=LM_TRAIN_RULES),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32, rules=LM_TRAIN_RULES),
    "decode_32k": dict(kind="decode", seq=32768, batch=128, rules=LM_DECODE_RULES),
    "long_500k": dict(kind="decode", seq=524288, batch=1, rules=LM_LONG_DECODE_RULES),
}


def lm_cells(long_ok: bool, long_skip_reason: str = "") -> Tuple[Cell, ...]:
    cells = []
    for shape, d in LM_SHAPES.items():
        skip = None
        if shape == "long_500k" and not long_ok:
            skip = long_skip_reason or (
                "pure full-attention arch: no sub-quadratic path for 500k decode "
                "(DESIGN.md §Arch-applicability)"
            )
        cells.append(Cell(shape=shape, kind=d["kind"], skip=skip, rules=d["rules"]))
    return tuple(cells)


def lm_model_flops(cfg, tokens: int, kind: str) -> float:
    """MODEL_FLOPS = 6*N*D (train) or 2*N*D (fwd); N = active params."""
    from repro_torch.models.transformer import lm_param_specs

    n_total = param_count(lm_param_specs(cfg))
    if cfg.moe:
        # subtract non-active expert params: active = top_k/n_experts of routed
        routed = 3 * cfg.n_experts_padded * cfg.d_model * cfg.d_ff_expert * cfg.n_layers
        n_active = n_total - routed + routed * cfg.top_k / cfg.n_experts_padded
    else:
        n_active = n_total
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active * tokens


def build_lm_dryrun(cfg, shape: str, mesh, cell: Cell) -> DryRunSpec:
    """The cell's step on meta tensors. A training step takes its batch as
    one microbatch, as the reference's flops mode does: the flops are the
    same, the Python dispatch a quarter or less, and the bytes leave out
    the weights' re-reads and the float32 accumulator of the microbatch
    loop. The loss head keeps its chunks (each recomputed in the backward)
    and attention its q chunks above 2048 x 2048 (`kernels.ops.attention`),
    as the step runs them.

    On a `ProcessMesh` every step is rank 0's own (`models/transformer.py`
    on a `MeshLayout` under the cell's rules): its shards of the state
    (`models.param.local_params`) and its rows of the batch; a decode cell's
    cache is rank 0's block (`local_kv_cache`) at pos = seq - 1, the last
    position. The flops do not depend on pos: the step attends over every
    position of its block, masked or not, as the reference attends over
    all of Smax. That position is owned by the last block along `kv_seq`
    (model rank 15 of data rank 0 under LM_DECODE_RULES, rank 255 under
    LM_LONG_DECODE_RULES on 16 x 16), so rank 0 writes no key or value."""
    from repro_torch.distributed.mesh_utils import local_shard
    from repro_torch.models import transformer as T
    from repro_torch.models.param import local_params

    n_groups_full = cfg.n_layers // cfg.group_size
    cfg = dataclasses.replace(cfg, grad_accum=1)
    d = LM_SHAPES[shape]
    rules = merged_rules(cell.rules)
    seq, batch = d["seq"], d["batch"]
    sharded = per_rank_mesh(mesh)
    with set_mesh_rules(mesh, rules) as lr:
        specs = T.lm_param_specs(cfg)
        ap = abstract_params(specs)
        pspecs = param_pspecs(specs, lr)
        n_params = param_count(specs)
        per_layer = lambda tree: T.unstack_layers(tree, cfg)
        tok_sh = lambda s: resolve_pspec(("batch", "seq" if s > 1 else None), (batch, s), lr)
        meta = {"params": n_params, "tokens": batch * seq, "seq": seq,
                "n_groups": n_groups_full, "kind": cell.kind, "per_rank": sharded}
        lay = T.MeshLayout(cfg, mesh, rules) if sharded else None
        on_rank = (lambda tree: local_params(tree, lay.specs, mesh)) if sharded else None
        rows = (lambda t: local_shard(t, tok_sh(t.shape[1]), mesh)) if sharded else (lambda t: t)

        if cell.kind == "train":
            from repro_torch.optim.adamw import AdamWConfig

            state, layout, state_sh = abstract_train_state(ap, pspecs, per_layer, on_rank)
            batch_abs = {"tokens": meta_tensor((batch, seq)), "labels": meta_tensor((batch, seq))}
            batch_sh = {"tokens": tok_sh(seq), "labels": tok_sh(seq)}
            fn = train_step_fn(lambda p, bb: T.loss_fn(p, bb, cfg, lay), AdamWConfig(),
                               schedule=True, mesh=mesh if sharded else None,
                               specs=lay.specs if sharded else None)
            return DryRunSpec(
                fn=fn, args=(state, {k: rows(v) for k, v in batch_abs.items()}),
                in_specs=(state_sh, batch_sh),
                state=(layout, batch_abs), donate=(0,), rules=rules,
                meta=dict(meta, model_flops=lm_model_flops(cfg, batch * seq, "train")))

        icfg = dataclasses.replace(cfg, remat=False)
        if cell.kind == "prefill":
            tok = meta_tensor((batch, seq))
            ilay = T.MeshLayout(icfg, mesh, rules) if sharded else None

            def prefill(params, tokens):
                if sharded:
                    return T.prefill_forward(params, tokens, icfg, ilay)
                return T.Transformer(icfg, params, device="meta").prefill_forward(tokens)

            params = per_layer(ap)
            return DryRunSpec(
                fn=prefill, args=(on_rank(params) if sharded else params, rows(tok)),
                in_specs=(pspecs, tok_sh(seq)),
                state=(ap, tok), rules=rules,
                meta=dict(meta, model_flops=lm_model_flops(cfg, batch * seq, "prefill")))

        # decode: one new token against a seq-long KV cache
        kv_abs = T.abstract_kv_cache(icfg, batch, seq)
        kv_sh = T.kv_cache_pspecs(icfg, batch, seq, lr)
        tok = meta_tensor((batch, 1))
        kv = kv_abs
        if sharded:
            ilay = T.MeshLayout(icfg, mesh, rules)
            kv = T.local_kv_cache(icfg, batch, seq, ilay, device="meta")
            for layer in kv["layers"]:
                layer["pos"] = seq - 1

        def decode(params, kv, tokens):
            if sharded:
                return T.serve_step(params, kv, tokens, icfg, ilay)
            return T.Transformer(icfg, params, device="meta").serve_step(kv, tokens)

        params = per_layer(ap)
        return DryRunSpec(
            fn=decode, args=(on_rank(params) if sharded else params, kv, rows(tok)),
            in_specs=(pspecs, kv_sh, tok_sh(1)), state=(ap, kv_abs, tok), donate=(1,),
            rules=rules,
            meta={"params": n_params, "tokens": batch,
                  "model_flops": lm_model_flops(cfg, batch, "decode"), "kind": "decode",
                  "per_rank": sharded})


# ---------------------------------------------------------------------------
# GNN family builder
# ---------------------------------------------------------------------------

GNN_RULES = {"nodes": ("data", "model"), "edges": ("data", "model")}

GNN_SHAPES = {
    "full_graph_sm": dict(kind="train", n_nodes=2708, n_edges=10556, d_feat=1433, n_out=7),
    "minibatch_lg": dict(
        kind="train", n_nodes=232_965, n_edges=114_615_892, batch_nodes=1024,
        fanout=(15, 10), d_feat=602, n_out=41,
    ),
    "ogb_products": dict(
        kind="train", n_nodes=2_449_029, n_edges=61_859_140, d_feat=100, n_out=47,
        distributed=True,
    ),
    "molecule": dict(kind="train", n_nodes=30, n_edges=64, batch=128, d_feat=16),
}


def gnn_cells() -> Tuple[Cell, ...]:
    return tuple(
        Cell(shape=s, kind=d["kind"], rules=GNN_RULES) for s, d in GNN_SHAPES.items()
    )


def _gnn_batch_abstract(shape: str, d: dict, needs_pos: bool, lr) -> Tuple[dict, dict]:
    """(meta batch, spec tree) for the non-distributed cells."""
    f32 = torch.float32
    if shape == "molecule":
        n = d["batch"] * d["n_nodes"]
        e = d["batch"] * d["n_edges"] * 2  # bidirected
        batch = {
            "node_feat": meta_tensor((n, d["d_feat"]), f32),
            "node_pos": meta_tensor((n, 3), f32),
            "src": meta_tensor((e,)),
            "dst": meta_tensor((e,)),
            "graph_id": meta_tensor((n,)),
            "graph_targets": meta_tensor((d["batch"], 1), f32),
            "labels": meta_tensor((n,)),
            "node_target": meta_tensor((n, 1), f32),
        }
    elif shape == "minibatch_lg":
        from repro_torch.graph.sampler import sampled_shape

        max_nodes, max_edges = sampled_shape(d["batch_nodes"], d["fanout"])
        batch = {
            "node_feat": meta_tensor((max_nodes, d["d_feat"]), f32),
            "node_pos": meta_tensor((max_nodes, 3), f32),
            "src": meta_tensor((max_edges,)),
            "dst": meta_tensor((max_edges,)),
            "labels": meta_tensor((max_nodes,)),
            "seed_mask": meta_tensor((max_nodes,), f32),
        }
    else:  # full_graph_sm
        n, e = d["n_nodes"], d["n_edges"]
        batch = {
            "node_feat": meta_tensor((n, d["d_feat"]), f32),
            "node_pos": meta_tensor((n, 3), f32),
            "src": meta_tensor((e,)),
            "dst": meta_tensor((e,)),
            "labels": meta_tensor((n,)),
        }
    if not needs_pos:
        batch.pop("node_pos", None)
    ax = {
        "node_feat": ("nodes", None),
        "node_pos": ("nodes", None),
        "src": ("edges",),
        "dst": ("edges",),
        "graph_id": ("nodes",),
        "graph_targets": (None, None),
        "labels": ("nodes",),
        "seed_mask": ("nodes",),
        "node_target": ("nodes", None),
    }
    return batch, {k: resolve_pspec(ax[k], v.shape, lr) for k, v in batch.items()}


def build_gnn_dryrun(arch_name: str, model_mod, model_cfg, shape: str, mesh, cell: Cell,
                     needs_pos: bool) -> DryRunSpec:
    from repro_torch.models.param import tree_map
    from repro_torch.optim.adamw import AdamWConfig

    d = GNN_SHAPES[shape]
    rules = merged_rules(cell.rules)
    with set_mesh_rules(mesh, rules) as lr:
        specs = model_mod.param_specs(model_cfg)
        ap = abstract_params(specs)
        n_params = param_count(specs)
        # GNN params are small: replicated (the graph is the sharded object)
        pspecs = tree_map(lambda s: (), specs)
        state, layout, state_sh = abstract_train_state(ap, pspecs)

        # MODEL_FLOPS for message passing ~= 6 * (per-edge MLP flops * E +
        # per-node MLP flops * N) -- computed as 6 * params_touched * items
        if shape == "molecule":
            e_eff = d["batch"] * d["n_edges"] * 2
            n_eff = d["batch"] * d["n_nodes"]
        elif shape == "minibatch_lg":
            e_eff, n_eff = 168_960, 169_984
        else:
            e_eff, n_eff = d["n_edges"], d["n_nodes"]
        meta = {"params": n_params, "tokens": n_eff, "edges": e_eff,
                "n_groups": model_cfg.n_layers,
                "model_flops": 6.0 * n_params * (e_eff + n_eff) / max(n_eff, 1),
                "kind": "train", "distributed": bool(d.get("distributed")),
                "per_rank": False}

        if d.get("distributed"):
            return _dist_gnn_spec(arch_name, model_cfg, d, mesh, state, layout, state_sh,
                                  rules, meta, needs_pos)
        inputs, ispecs = _gnn_batch_abstract(shape, d, needs_pos, lr)
        fn = train_step_fn(lambda p, b: model_mod.loss_fn(p, b, model_cfg),
                           AdamWConfig(weight_decay=0.0))
        return DryRunSpec(fn=fn, args=(state, inputs), in_specs=(state_sh, ispecs),
                          state=(layout, inputs), donate=(0,), rules=rules, meta=meta)


def _dist_gnn_spec(arch_name, model_cfg, d, mesh, state, layout, state_sh, rules, meta,
                   needs_pos) -> DryRunSpec:
    """ogb_products' full-graph step (`models/gnn/distributed.py`) at the
    reference's plan (edge chunks of 32768, 16384 for EquiformerV2): on a
    `ProcessMesh` rank 0's own step over its blocks of the graph (meta
    tensors of `local_dist_inputs`' shapes) with the parameters
    replicated; on a mesh that is only a shape, uncounted (the step runs
    over a process group)."""
    from repro_torch.distributed.mesh_utils import local_shard, mesh_axes
    from repro_torch.models.gnn.distributed import (
        abstract_dist_inputs, dist_input_pspecs, make_dist_gnn_loss, plan_dist_graph,
    )
    from repro_torch.optim.adamw import AdamWConfig

    axes = tuple(a for a in ("data", "model") if a in mesh_axes(mesh))
    dcfg = plan_dist_graph(d["n_nodes"], d["n_edges"], mesh_axes(mesh), d_feat=d["d_feat"],
                           n_out=d["n_out"],
                           edge_chunk=16384 if arch_name == "equiformer-v2" else 32768,
                           axes=axes)
    inputs = abstract_dist_inputs(dcfg, with_pos=needs_pos)
    ispecs = dist_input_pspecs(dcfg, with_pos=needs_pos)
    if not per_rank_mesh(mesh):
        return DryRunSpec(fn=None, args=(state, inputs), in_specs=(state_sh, ispecs),
                          state=(layout, inputs), rules=rules,
                          meta=dict(meta, not_counted=NEEDS_PROCESS_MESH))
    local = {k: local_shard(v, ispecs[k], mesh) for k, v in inputs.items()}
    fn = train_step_fn(make_dist_gnn_loss(arch_name, mesh, dcfg, model_cfg),
                       AdamWConfig(weight_decay=0.0))
    return DryRunSpec(fn=fn, args=(state, local), in_specs=(state_sh, ispecs),
                      state=(layout, inputs), donate=(0,), rules=rules,
                      meta=dict(meta, per_rank=True))


# why ogb_products' step is planned but not counted on a mesh that is only
# a shape: the sharded full-graph step runs over a process group
NEEDS_PROCESS_MESH = ("the sharded full-graph step (models/gnn/distributed.py) runs over a "
                      "process group: the dry run counts it as rank 0 of a fake one")
