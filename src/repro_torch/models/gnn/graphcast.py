"""GraphCast [arXiv:2212.12794]: encoder-processor-decoder mesh GNN (the
reference's `models/gnn/graphcast.py`). n_layers=16, d_hidden=512,
mesh_refinement=6, aggregator=sum, n_vars=227.

Two operating modes:

1. `weather` (the architecture's native form): grid features (N_grid,
   n_vars) -> grid2mesh encoder -> interaction-network layers on the
   icosahedral multimesh -> mesh2grid decoder -> next-state prediction (MSE).
2. `generic` (the zoo's graph shapes full_graph_sm / minibatch_lg /
   molecule, what the configs run): the same encode-process-decode stack
   with the input graph playing both grid and mesh roles (encoder and
   decoder become per-node MLPs; the processor layers run on the graph's
   edges).

Processor layer (interaction network with residuals, as in the paper):
  e'_ij = MLP_e([e_ij, h_src, h_dst]) + e_ij
  h'_i  = MLP_n([h_i, sum_j e'_ji]) + h_i

The segment sums run plain (`use_kernel=False`), as the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.gnn.egnn import mlp_spec
from repro_torch.models.gnn.message_passing import rows


@dataclasses.dataclass(frozen=True)
class GraphCastConfig:
    n_layers: int = 16
    d_hidden: int = 512
    n_vars: int = 227
    mesh_refinement: int = 6
    d_in: int = 227  # grid/node input features
    n_out: int = 227  # predicted vars (or classes in generic mode)
    mode: str = "weather"  # weather | generic
    task: str = "regression"  # regression | node_classification


def _mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    return F.silu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def param_specs(cfg: GraphCastConfig) -> dict:
    d = cfg.d_hidden
    proc_layer = lambda: {
        "edge_mlp": mlp_spec(3 * d, d, d),
        "node_mlp": mlp_spec(2 * d, d, d),
    }
    specs = {
        "node_enc": mlp_spec(cfg.d_in, d, d),
        "edge_enc": mlp_spec(1, d, d),  # edge features: length/affinity scalar
        "processor": [proc_layer() for _ in range(cfg.n_layers)],
        "node_dec": mlp_spec(d, d, cfg.n_out),
    }
    if cfg.mode == "weather":
        specs["g2m_mlp"] = mlp_spec(2 * d, d, d)
        specs["m2g_mlp"] = mlp_spec(2 * d, d, d)
    return specs


def _edges(src: torch.Tensor, dst: torch.Tensor):
    """(ok, src with dropped edges at 0, dst likewise, dst with them at -1)."""
    src, dst = src.long(), dst.long()
    ok = (src >= 0) & (dst >= 0)
    return ok, torch.where(ok, src, 0), torch.where(ok, dst, 0), torch.where(ok, dst, -1)


def _mp_round(lp, h, e, edges, n):
    ok, s, t, dstm = edges
    e_new = _mlp(lp["edge_mlp"], torch.cat([e, rows(h, s), rows(h, t)], -1)) + e
    e_new = torch.where(ok[:, None], e_new, 0.0)
    agg = ops.segment_sum(e_new, dstm, n, use_kernel=False)
    return _mlp(lp["node_mlp"], torch.cat([h, agg], -1)) + h, e_new


def _edge_init(params, ok):
    e = _mlp(params["edge_enc"], torch.ones((ok.shape[0], 1), device=ok.device))
    return torch.where(ok[:, None], e, 0.0)


def forward_generic(params: dict, batch: dict, cfg: GraphCastConfig) -> torch.Tensor:
    h = _mlp(params["node_enc"], batch["node_feat"])
    edges = _edges(batch["src"], batch["dst"])
    n = h.shape[0]
    e = _edge_init(params, edges[0])
    for lp in params["processor"]:
        h, e = _mp_round(lp, h, e, edges, n)
    return _mlp(params["node_dec"], h)


def forward_weather(params: dict, batch: dict, cfg: GraphCastConfig) -> torch.Tensor:
    """batch: grid_feat (Ng, n_vars), n_mesh, mesh edges (mesh_src,
    mesh_dst), grid2mesh (g2m_*) and mesh2grid (m2g_*) edges."""
    ng = batch["grid_feat"].shape[0]
    nm = int(batch["n_mesh"])
    hg = _mlp(params["node_enc"], batch["grid_feat"])  # (Ng, d)

    # grid2mesh encode: mesh node = sum of MLP([h_grid, h_mesh0]) over g2m edges
    hm = torch.zeros((nm, cfg.d_hidden), dtype=torch.float32, device=hg.device)
    okg, gs, gd, gdm = _edges(batch["g2m_src"], batch["g2m_dst"])
    msg = _mlp(params["g2m_mlp"], torch.cat([rows(hg, gs), rows(hm, gd)], -1))
    msg = torch.where(okg[:, None], msg, 0.0)
    hm = hm + ops.segment_sum(msg, gdm, nm, use_kernel=False)

    # processor on the multimesh
    edges = _edges(batch["mesh_src"], batch["mesh_dst"])
    e = _edge_init(params, edges[0])
    for lp in params["processor"]:
        hm, e = _mp_round(lp, hm, e, edges, nm)

    # mesh2grid decode
    okd, ms, md, mdm = _edges(batch["m2g_src"], batch["m2g_dst"])
    msg = _mlp(params["m2g_mlp"], torch.cat([rows(hm, ms), rows(hg, md)], -1))
    msg = torch.where(okd[:, None], msg, 0.0)
    hg = hg + ops.segment_sum(msg, mdm, ng, use_kernel=False)
    return _mlp(params["node_dec"], hg)


def loss_fn(params: dict, batch: dict, cfg: GraphCastConfig) -> Tuple[torch.Tensor, dict]:
    if cfg.mode == "weather":
        loss = L.mse(forward_weather(params, batch, cfg), batch["grid_target"])
        return loss, {"mse": loss}
    out = forward_generic(params, batch, cfg)
    if cfg.task == "regression":
        loss = L.mse(out, batch["node_target"])
        return loss, {"mse": loss}
    loss = L.cross_entropy_loss(out, batch["labels"], batch.get("seed_mask"))
    return loss, {"ce": loss}
