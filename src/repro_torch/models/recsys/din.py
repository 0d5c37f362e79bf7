"""DIN: Deep Interest Network [arXiv:1706.06978] (the reference's
`models/recsys/din.py`).

embed_dim=18, seq_len=100, attention MLP 80-40, main MLP 200-80,
interaction = target attention over the user behavior sequence.

  item/category embedding tables (the large sparse state), looked up by a
  plain row gather, as the reference's `jnp.take` (ids < 0 give zero
  vectors);
  per-history-item attention unit: a(h, c) = MLP([h, c, h-c, h*c]) -> weight;
  user vector = sum_t a_t * h_t (un-normalized weights, as the paper);
  concat [user_vec, cand, user_profile] -> MLP 200-80 -> logit; BCE loss.

Paths: train_batch (B=65,536) `loss_fn`; serve_p99 (B=512) and serve_bulk
(B=262,144) `score`; retrieval_cand (1 x 1M) `retrieval_scores`, one
user's vector against every candidate in one batched MLP.

On a mesh (`MeshLayout`; the reference binds every cell to
`configs.din.DIN_RULES`), every rank calls `score`, `loss_fn` or
`retrieval_scores` at once on its shards (`models.param.local_params`)
and its block of the batch (`MeshLayout.local_batch`). The tables are the
decoupled storage tier: split over "model" (a contiguous block of rows a
rank, as the spec gives it), read through the owner. Where every model rank
holds the same ids, each gathers the ids in its own block, 0 elsewhere, and
the rows are psum'd over "model" (one addend is nonzero); where the ids
differ along "model" (candidates split over ("data", "model")), they are
bucketed by owner and exchanged (`block_gather`, every request served). A layer whose columns split over "model"
gives each rank its columns and gathers the activation whole for the next
layer; a layer that stays whole runs alike on every model rank. Where the
rows differ along "model", a split layer's leaves are gathered whole
instead. Every leaf enters the row axes it is not split on (the
data-parallel gradient sum). The loss is the mean over the global batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.storage import sharded_feature_gather
from repro_torch.distributed import collectives as C
from repro_torch.distributed.mesh_utils import (
    DEFAULT_RULES, LogicalRules, layout as spec_layout, local_shard, mesh_axes, resolve_pspec,
    split_axes,
)
from repro_torch.models import layers as L
from repro_torch.models.param import ParamSpec, param_pspecs


@dataclasses.dataclass(frozen=True)
class DINConfig:
    embed_dim: int = 18
    seq_len: int = 100
    n_items: int = 1_048_576  # 2^20
    n_cats: int = 16_384
    attn_hidden: Tuple[int, ...] = (80, 40)
    mlp_hidden: Tuple[int, ...] = (200, 80)
    d_profile: int = 8  # dense user-profile features


def _mlp_specs(dims, prefix):
    out = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"{prefix}_w{i}"] = ParamSpec((a, b), ("embed", "mlp"), dtype=torch.float32)
        out[f"{prefix}_b{i}"] = ParamSpec((b,), ("mlp",), init="zeros", dtype=torch.float32)
    return out


def param_specs(cfg: DINConfig) -> dict:
    d = cfg.embed_dim
    din_in = 2 * d  # [hist_item||hist_cat] and [cand_item||cand_cat]
    attn_dims = (4 * din_in,) + tuple(cfg.attn_hidden) + (1,)
    mlp_dims = (2 * din_in + cfg.d_profile,) + tuple(cfg.mlp_hidden) + (1,)
    specs = {
        "item_table": ParamSpec((cfg.n_items, d), ("storage", "embed"), scale=0.01,
                                dtype=torch.float32),
        "cat_table": ParamSpec((cfg.n_cats, d), ("storage", "embed"), scale=0.01,
                               dtype=torch.float32),
    }
    specs.update(_mlp_specs(attn_dims, "attn"))
    specs.update(_mlp_specs(mlp_dims, "mlp"))
    return specs


def _run_mlp(params, prefix, x, n_layers):
    return L.mlp_stack(x, [params[f"{prefix}_w{i}"] for i in range(n_layers)],
                       [params[f"{prefix}_b{i}"] for i in range(n_layers)])


def _embed_pair(params, item_ids, cat_ids):
    """item+cat embedding concat; -1 ids give zero vectors. A row gather by
    `F.embedding`, whose backward sums each table row's gradient after a
    sort of the ids: `table[ids]`'s backward (`index_put_` with
    accumulate) takes duplicates one after another, and the category
    table's 16,384 rows take 6.5 M lookups a train_batch step."""
    ok = (item_ids >= 0)[..., None]
    it = F.embedding(item_ids.long().clamp(min=0), params["item_table"])
    ct = F.embedding(cat_ids.long().clamp(min=0), params["cat_table"])
    return torch.where(ok, torch.cat([it, ct], -1), 0.0)


def user_vector(params: dict, batch: dict, cfg: DINConfig) -> torch.Tensor:
    """Target attention: returns (B, 2d) interest vector w.r.t. candidate."""
    hist = _embed_pair(params, batch["hist_items"], batch["hist_cats"])  # (B,L,2d)
    cand = _embed_pair(params, batch["cand_item"], batch["cand_cat"])  # (B,2d)
    c = cand[:, None, :].expand_as(hist)
    att_in = torch.cat([hist, c, hist - c, hist * c], -1)  # (B,L,8d)
    w = _run_mlp(params, "attn", att_in, len(cfg.attn_hidden) + 1)[..., 0]  # (B,L)
    w = torch.where(batch["hist_items"] >= 0, w, 0.0)  # paper: no softmax norm
    return torch.einsum("bl,bld->bd", w, hist)


def score(params: dict, batch: dict, cfg: DINConfig,
          layout: "MeshLayout" = None) -> torch.Tensor:
    """CTR logit per example. batch: hist_items/hist_cats (B,L),
    cand_item/cand_cat (B,), profile (B,d_profile). On a mesh: this
    rank's rows, the same on every model rank."""
    if layout is not None:
        return _mesh_score(params, batch, cfg, layout)
    uv = user_vector(params, batch, cfg)
    cand = _embed_pair(params, batch["cand_item"], batch["cand_cat"])
    x = torch.cat([uv, cand, batch["profile"]], -1)
    return _run_mlp(params, "mlp", x, len(cfg.mlp_hidden) + 1)[..., 0]  # (B,)


def loss_fn(params: dict, batch: dict, cfg: DINConfig,
            layout: "MeshLayout" = None) -> Tuple[torch.Tensor, dict]:
    """Mean binary cross-entropy of the logits, in the stable form
    max(z, 0) - z y + log1p(exp(-|z|)) (maximum: half the gradient at 0,
    as the reference's). On a mesh: the psum of the ranks' summed terms
    over the psum of their row counts, over the batch axes, the same on
    every rank."""
    logit = score(params, batch, cfg, layout)
    y = batch["label"].float()
    per = torch.maximum(logit, logit.new_zeros(())) - logit * y + \
        torch.log1p(torch.exp(-torch.abs(logit)))
    if layout is None:
        loss = L.div(torch.sum(per), float(per.numel()))
        return loss, {"bce": loss}
    num = torch.sum(per)
    count = torch.full((), float(per.numel()), device=num.device)
    if layout.batch_axes:
        g = layout.mesh.group(layout.batch_axes)
        num, count = C.psum(num, g), C.psum(count, g)
    loss = num / count
    return loss, {"bce": loss}


def retrieval_scores(params: dict, batch: dict, cfg: DINConfig,
                     layout: "MeshLayout" = None) -> torch.Tensor:
    """One user against n_candidates items: batched dot + shared-MLP scoring.

    batch: hist_items/hist_cats (1,L), profile (1,dp),
           cand_items/cand_cats (n_cand,).
    The attention unit depends on the candidate, so the faithful DIN
    formulation recomputes it per candidate, O(n_cand * L). As the
    reference, retrieval takes the two-stage approximation: a
    candidate-independent user vector (uniform attention over the valid
    history) and full MLP scoring, one (n_cand, .) batched MLP. On a mesh
    (a layout built with the global `n_candidates`): this rank's block of
    the candidates, the history whole on every rank.
    """
    if layout is not None:
        return _mesh_retrieval(params, batch, cfg, layout)
    hist = _embed_pair(params, batch["hist_items"], batch["hist_cats"])  # (1,L,2d)
    okl = (batch["hist_items"] >= 0).float()
    uv = torch.einsum("bl,bld->bd", okl, hist) / torch.clamp(okl.sum(-1, keepdim=True), min=1)
    cand = _embed_pair(params, batch["cand_items"], batch["cand_cats"])  # (nc,2d)
    nc = cand.shape[0]
    x = torch.cat([uv.expand(nc, -1), cand, batch["profile"].expand(nc, -1)], -1)
    return _run_mlp(params, "mlp", x, len(cfg.mlp_hidden) + 1)[..., 0]  # (nc,)


# ---------------------------------------------------------------------------
# DIN on a mesh
# ---------------------------------------------------------------------------


def batch_axes(keys) -> dict:
    """The logical axes of a DIN batch's keys (the reference's dry run's): a
    retrieval batch (with "cand_items") has one user's history whole on
    every rank and its candidates over "cand"; any other its rows over
    "batch"."""
    if "cand_items" in keys:
        ax = {"hist_items": (None, None), "hist_cats": (None, None), "profile": (None, None),
              "cand_items": ("cand",), "cand_cats": ("cand",)}
    else:
        ax = {"hist_items": ("batch", None), "hist_cats": ("batch", None),
              "cand_item": ("batch",), "cand_cat": ("batch",), "profile": ("batch", None),
              "label": ("batch",)}
    return {k: ax[k] for k in keys}


def _big(mesh, entry) -> tuple:
    """The axes of a spec entry whose size is over 1."""
    names = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
    return tuple(a for a in names if mesh_axes(mesh)[a] > 1)


class MeshLayout:
    """Where DIN's leaves and its batch lie on a `ProcessMesh` under
    `rules` (default `mesh_utils.DEFAULT_RULES`; the reference binds its
    cells to `configs.din.DIN_RULES`): every leaf's resolved spec
    (`specs`), the batch axes, this rank's place on "model", and, for a
    retrieval batch of `n_candidates`, the axes its candidates split over.
    Every rank builds it alike."""

    def __init__(self, cfg: DINConfig, mesh, rules=None, n_candidates=None):
        self.cfg, self.mesh = cfg, mesh
        self.lr = LogicalRules(mesh, dict(rules or DEFAULT_RULES))
        self.specs = param_pspecs(param_specs(cfg), self.lr)
        axes = mesh_axes(mesh)
        every = math.prod(axes.values())  # a length every axis divides
        self.batch_axes = _big(mesh, resolve_pspec(("batch",), (every,), self.lr)[0])
        self.cand_axes = None
        if n_candidates is not None:
            self.cand_axes = _big(mesh, resolve_pspec(("cand",), (n_candidates,), self.lr)[0])
        self.n_model = axes.get("model", 1)
        self.m = mesh.axis_index("model") if self.n_model > 1 else 0
        self.g_model = mesh.group("model") if self.n_model > 1 else None

    def local_batch(self, batch: dict) -> dict:
        """This rank's block of each tensor of a global batch, under the
        spec its logical axes (`batch_axes`) resolve to at its shape."""
        ax = batch_axes(batch)
        return {k: local_shard(v, resolve_pspec(ax[k], tuple(v.shape), self.lr), self.mesh)
                for k, v in batch.items()}

    def split_on_model(self, spec, dim: int) -> bool:
        return self.n_model > 1 and "model" in spec_layout(spec).get(dim, ())

    def enter(self, w: torch.Tensor, spec, rows) -> torch.Tensor:
        """A leaf entering the row axes `rows` it is not split on: its use
        differs with the rows, so its gradient sums over them."""
        cross = tuple(a for a in rows if a not in split_axes(spec))
        return C.enter(w, self.mesh.group(cross)) if cross else w


def _mesh_tables(params, lay: MeshLayout, rows) -> dict:
    """The two tables as this rank's lookups read them, each entering the
    row axes `rows` once (every lookup of a call shares the gradient sum)."""
    return {k: lay.enter(params[k], lay.specs[k], rows) for k in ("item_table", "cat_table")}


def block_gather(ids: torch.Tensor, local: torch.Tensor, group, n_shards: int):
    """Rows of a table split over `group` in contiguous blocks of R =
    local.shape[0] rows a rank (`local_shard`'s layout): owner(r) = r // R,
    slot r % R. Each id is renamed to its striped id (r % R) * n_shards +
    r // R, whose stripe owner and slot are those, and read through
    `sharded_feature_gather` at the budget of every request. ids: (M,),
    -1 padded; returns (rows (M, F), served (M,) bool)."""
    R = local.shape[0]
    striped = torch.where(ids >= 0, ids % R * n_shards + ids // R, -1)
    return sharded_feature_gather(striped, local, group, n_shards, ids.numel())


def _mesh_embed_pair(tables, item_ids, cat_ids, lay: MeshLayout, differ: bool):
    """`_embed_pair` on a mesh (`tables`: `_mesh_tables`'), through each
    table's owner: the same ids on
    every model rank (each rank's rows of its block, 0 elsewhere, psum'd
    over "model"), or, with `differ`, ids of its own (bucketed by owner and
    exchanged, every request served). -1 item ids give zero vectors, as
    the reference's."""
    ok = (item_ids >= 0)[..., None]
    parts, owned = [], []
    for name, ids in (("item_table", item_ids), ("cat_table", cat_ids)):
        spec, t = lay.specs[name], tables[name]
        ids = ids.long().clamp(min=0)
        if not lay.split_on_model(spec, 0):
            parts.append(F.embedding(ids, t))
            owned.append(False)
        elif differ:
            got, _ = block_gather(ids.reshape(-1), t, lay.g_model, lay.n_model)
            parts.append(got.view(*ids.shape, t.shape[1]))
            owned.append(False)
        else:
            R = t.shape[0]
            local = ids - lay.m * R
            mine = ((local >= 0) & (local < R))[..., None]
            parts.append(torch.where(mine, F.embedding(local.clamp(0, R - 1), t), 0.0))
            owned.append(True)
    if all(owned):  # one psum of both tables' rows
        x = C.psum(torch.cat(parts, -1), lay.g_model)
    else:
        x = torch.cat([C.psum(p, lay.g_model) if o else p for p, o in zip(parts, owned)], -1)
    return torch.where(ok, x, 0.0)


def _mesh_mlp(params, prefix: str, x: torch.Tensor, n_layers: int, lay: MeshLayout, rows,
              differ: bool) -> torch.Tensor:
    """`_run_mlp` on a mesh over this rank's rows x: a layer split by
    column over "model" gives each rank its columns (x entering "model")
    and gathers the activation whole; with `differ` (rows of its own on
    each model rank) the split leaves are gathered whole instead; a whole
    layer runs alike on every model rank."""
    for i in range(n_layers):
        kw, kb = f"{prefix}_w{i}", f"{prefix}_b{i}"
        w = lay.enter(params[kw], lay.specs[kw], rows)
        b = lay.enter(params[kb], lay.specs[kb], rows)
        split = lay.split_on_model(lay.specs[kw], 1)
        if split and differ:
            w, b = C.all_gather(w, lay.g_model, 1), C.all_gather(b, lay.g_model, 0)
            split = False
        x = (C.enter(x, lay.g_model) if split else x) @ w + b
        if i < n_layers - 1:
            x = F.relu(x)
        if split:
            x = C.gather_invariant(x, lay.g_model, -1)
    return x


def _mesh_user_vector(params, tables, batch, cand, cfg: DINConfig, lay: MeshLayout):
    rows = lay.batch_axes
    hist = _mesh_embed_pair(tables, batch["hist_items"], batch["hist_cats"], lay, False)
    c = cand[:, None, :].expand_as(hist)
    att_in = torch.cat([hist, c, hist - c, hist * c], -1)
    w = _mesh_mlp(params, "attn", att_in, len(cfg.attn_hidden) + 1, lay, rows, False)[..., 0]
    w = torch.where(batch["hist_items"] >= 0, w, 0.0)
    return torch.einsum("bl,bld->bd", w, hist)


def _mesh_score(params, batch, cfg: DINConfig, lay: MeshLayout) -> torch.Tensor:
    rows = lay.batch_axes
    tables = _mesh_tables(params, lay, rows)
    cand = _mesh_embed_pair(tables, batch["cand_item"], batch["cand_cat"], lay, False)
    uv = _mesh_user_vector(params, tables, batch, cand, cfg, lay)
    x = torch.cat([uv, cand, batch["profile"]], -1)
    return _mesh_mlp(params, "mlp", x, len(cfg.mlp_hidden) + 1, lay, rows, False)[..., 0]


def _mesh_retrieval(params, batch, cfg: DINConfig, lay: MeshLayout) -> torch.Tensor:
    if lay.cand_axes is None:
        raise ValueError("retrieval on a mesh: build the layout with n_candidates")
    rows = lay.cand_axes
    differ = "model" in rows
    tables = _mesh_tables(params, lay, rows)
    hist = _mesh_embed_pair(tables, batch["hist_items"], batch["hist_cats"], lay, False)
    okl = (batch["hist_items"] >= 0).float()
    uv = torch.einsum("bl,bld->bd", okl, hist) / torch.clamp(okl.sum(-1, keepdim=True), min=1)
    if differ:  # the same on every model rank, read by rows of each rank's own
        uv = C.enter(uv, lay.g_model)
    cand = _mesh_embed_pair(tables, batch["cand_items"], batch["cand_cats"], lay, differ)
    nc = cand.shape[0]
    x = torch.cat([uv.expand(nc, -1), cand, batch["profile"].expand(nc, -1)], -1)
    return _mesh_mlp(params, "mlp", x, len(cfg.mlp_hidden) + 1, lay, rows, differ)[..., 0]
