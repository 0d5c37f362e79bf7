"""EGNN: E(n)-equivariant GNN [arXiv:2102.09844] (the reference's
`models/gnn/egnn.py`). n_layers=4, d_hidden=64.

Per layer (Eqs. 3-6 of the paper):
  m_ij  = phi_e(h_i, h_j, ||x_i - x_j||^2)
  x_i'  = x_i + (1/deg_i) sum_j (x_i - x_j) * phi_x(m_ij)
  h_i'  = phi_h(h_i, sum_j m_ij)

Node classification, or graph regression pooled over `graph_id`
(molecule). The segment sums run plain (`use_kernel=False`), as the
reference's run off its Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.gnn.message_passing import degree, rows
from repro_torch.models.param import ParamSpec


@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    n_layers: int = 4
    d_hidden: int = 64
    d_in: int = 16
    n_out: int = 1  # regression targets (molecule) or classes (node tasks)
    task: str = "graph_regression"  # graph_regression | node_classification
    n_graphs: int = 1  # batched molecules


def mlp_spec(d_in: int, d_hidden: int, d_out: int) -> dict:
    """Specs of a two-layer MLP (w1, b1, w2, b2), float32."""
    f32 = torch.float32
    return {
        "w1": ParamSpec((d_in, d_hidden), ("embed", "mlp"), dtype=f32),
        "b1": ParamSpec((d_hidden,), ("mlp",), init="zeros", dtype=f32),
        "w2": ParamSpec((d_hidden, d_out), ("mlp", "embed"), dtype=f32),
        "b2": ParamSpec((d_out,), ("embed",), init="zeros", dtype=f32),
    }


def _mlp(p: dict, x: torch.Tensor, final_act: bool = False) -> torch.Tensor:
    x = F.silu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
    return F.silu(x) if final_act else x


def param_specs(cfg: EGNNConfig) -> dict:
    d = cfg.d_hidden
    layer = lambda: {
        "phi_e": mlp_spec(2 * d + 1, d, d),
        "phi_x": mlp_spec(d, d, 1),
        "phi_h": mlp_spec(2 * d, d, d),
    }
    return {
        "encoder": mlp_spec(cfg.d_in, d, d),
        "layers": [layer() for _ in range(cfg.n_layers)],
        "decoder": mlp_spec(d, d, cfg.n_out),
    }


def forward(params: dict, batch: dict, cfg: EGNNConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h (N, d), x (N, 3)): invariant features and updated coordinates."""
    h = _mlp(params["encoder"], batch["node_feat"], final_act=True)  # (N, d)
    x = batch["node_pos"].float()  # (N, 3)
    src, dst = batch["src"].long(), batch["dst"].long()
    ok = (src >= 0) & (dst >= 0)
    s = torch.where(ok, src, 0)
    t = torch.where(ok, dst, 0)
    dstm = torch.where(ok, dst, -1)
    n = h.shape[0]
    deg = torch.clamp(degree(dstm, n), min=1.0)

    for lp in params["layers"]:
        diff = rows(x, t) - rows(x, s)  # (E, 3) x_i - x_j with i=dst receiving
        dist2 = torch.sum(diff * diff, -1, keepdim=True)
        m = _mlp(lp["phi_e"], torch.cat([rows(h, t), rows(h, s), dist2], -1), final_act=True)
        m = torch.where(ok[:, None], m, 0.0)
        w = _mlp(lp["phi_x"], m)  # (E, 1)
        x = x + ops.segment_sum(diff * w, dstm, n, use_kernel=False) / deg[:, None]
        agg = ops.segment_sum(m, dstm, n, use_kernel=False)
        h = h + _mlp(lp["phi_h"], torch.cat([h, agg], -1))
    return h, x


def graph_mean(out: torch.Tensor, graph_id: torch.Tensor, n_graphs: int) -> torch.Tensor:
    """(n_graphs, D) mean of `out`'s rows by graph id; ids < 0 are left out."""
    okn = graph_id >= 0
    gid = torch.where(okn, graph_id.long(), 0)
    pooled = ops.segment_sum(torch.where(okn[:, None], out, 0.0), gid, n_graphs,
                             use_kernel=False)
    cnt = ops.segment_sum(okn.float()[:, None], gid, n_graphs, use_kernel=False)
    return pooled / torch.clamp(cnt, min=1)


def loss_fn(params: dict, batch: dict, cfg: EGNNConfig) -> Tuple[torch.Tensor, dict]:
    h, _ = forward(params, batch, cfg)
    out = _mlp(params["decoder"], h)  # (N, n_out)
    if cfg.task == "graph_regression":
        pred = graph_mean(out, batch["graph_id"], cfg.n_graphs)
        loss = L.mse(pred, batch["graph_targets"])
        return loss, {"mse": loss}
    loss = L.cross_entropy_loss(out, batch["labels"], batch.get("seed_mask"))
    return loss, {"ce": loss}
