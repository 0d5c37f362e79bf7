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
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.param import ParamSpec


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


def score(params: dict, batch: dict, cfg: DINConfig) -> torch.Tensor:
    """CTR logit per example. batch: hist_items/hist_cats (B,L),
    cand_item/cand_cat (B,), profile (B,d_profile)."""
    uv = user_vector(params, batch, cfg)
    cand = _embed_pair(params, batch["cand_item"], batch["cand_cat"])
    x = torch.cat([uv, cand, batch["profile"]], -1)
    return _run_mlp(params, "mlp", x, len(cfg.mlp_hidden) + 1)[..., 0]  # (B,)


def loss_fn(params: dict, batch: dict, cfg: DINConfig) -> Tuple[torch.Tensor, dict]:
    """Mean binary cross-entropy of the logits, in the stable form
    max(z, 0) - z y + log1p(exp(-|z|)) (maximum: half the gradient at 0,
    as the reference's)."""
    logit = score(params, batch, cfg)
    y = batch["label"].float()
    per = torch.maximum(logit, logit.new_zeros(())) - logit * y + \
        torch.log1p(torch.exp(-torch.abs(logit)))
    loss = L.div(torch.sum(per), float(per.numel()))
    return loss, {"bce": loss}


def retrieval_scores(params: dict, batch: dict, cfg: DINConfig) -> torch.Tensor:
    """One user against n_candidates items: batched dot + shared-MLP scoring.

    batch: hist_items/hist_cats (1,L), profile (1,dp),
           cand_items/cand_cats (n_cand,).
    The attention unit depends on the candidate, so the faithful DIN
    formulation recomputes it per candidate, O(n_cand * L). As the
    reference, retrieval takes the two-stage approximation: a
    candidate-independent user vector (uniform attention over the valid
    history) and full MLP scoring, one (n_cand, .) batched MLP.
    """
    hist = _embed_pair(params, batch["hist_items"], batch["hist_cats"])  # (1,L,2d)
    okl = (batch["hist_items"] >= 0).float()
    uv = torch.einsum("bl,bld->bd", okl, hist) / torch.clamp(okl.sum(-1, keepdim=True), min=1)
    cand = _embed_pair(params, batch["cand_items"], batch["cand_cats"])  # (nc,2d)
    nc = cand.shape[0]
    x = torch.cat([uv.expand(nc, -1), cand, batch["profile"].expand(nc, -1)], -1)
    return _run_mlp(params, "mlp", x, len(cfg.mlp_hidden) + 1)[..., 0]  # (nc,)
