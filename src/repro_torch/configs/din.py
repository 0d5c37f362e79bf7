"""din [arXiv:1706.06978]: embed_dim=18 seq_len=100 attn_mlp=80-40
mlp=200-80, interaction = target attention.

Shapes: train_batch (B=65,536), serve_p99 (B=512), serve_bulk (B=262,144),
retrieval_cand (batch=1 x 1,000,000 candidates, batched-dot scoring).

The embedding tables are the decoupled storage tier: vocab rows sharded over
the "storage" -> model axis, as gRouting's adjacency rows are.

Given a `ProcessMesh`, the dry run counts rank 0's own step under
`DIN_RULES` (`models/recsys/din.py` `MeshLayout`: its shards of the tables
and MLPs, its block of the batch; `meta["per_rank"]`); given a mesh that is
only a shape, the step of one device."""

from __future__ import annotations

import torch

from repro_torch.configs.base import (
    ArchDef, Cell, DryRunSpec, abstract_train_state, merged_rules, meta_tensor, per_rank_mesh,
    train_step_fn,
)
from repro_torch.distributed.mesh_utils import resolve_pspec, set_mesh_rules
from repro_torch.models.param import abstract_params, local_params, param_count, param_pspecs
from repro_torch.models.recsys import din as model

DIN_RULES = {"batch": ("pod", "data"), "storage": "model", "cand": ("data", "model")}

SHAPES = {
    "train_batch": dict(kind="train", batch=65_536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262_144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_000),
}


def model_cfg() -> model.DINConfig:
    return model.DINConfig(
        embed_dim=18, seq_len=100, n_items=1_048_576, n_cats=16_384,
        attn_hidden=(80, 40), mlp_hidden=(200, 80), d_profile=8,
    )


def smoke_cfg() -> model.DINConfig:
    return model.DINConfig(
        embed_dim=8, seq_len=12, n_items=1024, n_cats=64,
        attn_hidden=(16, 8), mlp_hidden=(24, 12), d_profile=4,
    )


def _batch_abstract(shape: str, cfg: model.DINConfig, lr):
    d = SHAPES[shape]
    f32 = torch.float32
    if shape == "retrieval_cand":
        nc = d["n_candidates"]
        b = {
            "hist_items": meta_tensor((1, cfg.seq_len)),
            "hist_cats": meta_tensor((1, cfg.seq_len)),
            "profile": meta_tensor((1, cfg.d_profile), f32),
            "cand_items": meta_tensor((nc,)),
            "cand_cats": meta_tensor((nc,)),
        }
    else:
        B = d["batch"]
        b = {
            "hist_items": meta_tensor((B, cfg.seq_len)),
            "hist_cats": meta_tensor((B, cfg.seq_len)),
            "cand_item": meta_tensor((B,)),
            "cand_cat": meta_tensor((B,)),
            "profile": meta_tensor((B, cfg.d_profile), f32),
            "label": meta_tensor((B,)),
        }
        if shape != "train_batch":
            b.pop("label")
    ax = model.batch_axes(b)
    return b, {k: resolve_pspec(ax[k], v.shape, lr) for k, v in b.items()}


def build_dryrun(shape: str, mesh) -> DryRunSpec:
    from repro_torch.optim.adamw import AdamWConfig

    cfg = model_cfg()
    cell = ARCH.cell(shape)
    rules = merged_rules(cell.rules)
    sharded = per_rank_mesh(mesh)
    with set_mesh_rules(mesh, rules) as lr:
        specs = model.param_specs(cfg)
        ap = abstract_params(specs)
        pspecs = param_pspecs(specs, lr)
        n_params = param_count(specs)
        batch_abs, batch_sh = _batch_abstract(shape, cfg, lr)
        d = SHAPES[shape]

        # MODEL_FLOPS: per-example = attention MLP over L steps + main MLP
        din_in = 2 * cfg.embed_dim
        attn_dims = (4 * din_in,) + tuple(cfg.attn_hidden) + (1,)
        mlp_dims = (2 * din_in + cfg.d_profile,) + tuple(cfg.mlp_hidden) + (1,)
        attn_f = sum(a * b for a, b in zip(attn_dims[:-1], attn_dims[1:]))
        mlp_f = sum(a * b for a, b in zip(mlp_dims[:-1], mlp_dims[1:]))
        items = d.get("n_candidates", d["batch"])
        per_ex = 2 * (cfg.seq_len * attn_f + mlp_f)
        mult = 3.0 if cell.kind == "train" else 1.0

        # on a ProcessMesh: rank 0's shards and its block of the batch
        lay = model.MeshLayout(cfg, mesh, rules, d.get("n_candidates")) if sharded else None
        on_rank = (lambda tree: local_params(tree, lay.specs, mesh)) if sharded else None
        rows = lay.local_batch(batch_abs) if sharded else batch_abs

        if cell.kind == "train":
            state, layout, state_sh = abstract_train_state(ap, pspecs, local=on_rank)
            fn = train_step_fn(lambda p, bb: model.loss_fn(p, bb, cfg, lay),
                               AdamWConfig(weight_decay=0.0), mesh=mesh if sharded else None,
                               specs=lay.specs if sharded else None)
            return DryRunSpec(
                fn=fn, args=(state, rows), in_specs=(state_sh, batch_sh),
                state=(layout, batch_abs), donate=(0,), rules=rules,
                meta={"params": n_params, "tokens": items,
                      "model_flops": mult * per_ex * items, "kind": "train",
                      "per_rank": sharded})

        if cell.kind == "retrieval":
            fn = lambda p, b: model.retrieval_scores(p, b, cfg, lay)
            # retrieval approximates with the candidate-independent user vec
            per_ex = 2 * mlp_f
        else:
            fn = lambda p, b: model.score(p, b, cfg, lay)
        return DryRunSpec(
            fn=fn, args=(on_rank(ap) if sharded else ap, rows), in_specs=(pspecs, batch_sh),
            state=(ap, batch_abs), rules=rules,
            meta={"params": n_params, "tokens": items,
                  "model_flops": per_ex * items, "kind": cell.kind, "per_rank": sharded})


ARCH = ArchDef(
    name="din",
    family="recsys",
    cells=tuple(Cell(shape=s, kind=d["kind"], rules=DIN_RULES) for s, d in SHAPES.items()),
    model_cfg=model_cfg,
    smoke_cfg=smoke_cfg,
    build_dryrun=build_dryrun,
)
