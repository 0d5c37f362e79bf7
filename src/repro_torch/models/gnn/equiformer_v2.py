"""EquiformerV2 [arXiv:2306.12059]: equivariant graph attention via eSCN
convolutions (the reference's `models/gnn/equiformer_v2.py`). n_layers=12,
d_hidden=128, l_max=6, m_max=2, n_heads=8.

Feature layout: node irreps x (N, n_coeff, C) where the coefficient axis
enumerates (l, m) with l <= l_max and |m| <= min(l, m_max):
  l=0: m=0           (1)
  l=1: m=-1,0,1      (3)
  l=2..6: m=-2..2    (5 each, 25)
  total n_coeff = 29 for (l_max=6, m_max=2)

Per layer, as the reference:
  - per-edge SO(2) convolution: coefficients mixed only along the l axis
    within each |m| block (separable: an (n_idx, n_idx) l-mix and a (C, C)
    channel mix), scaled by a radial-basis-conditioned weight per block;
  - equivariant graph attention: invariant (l=0) channels give per-head
    edge scores -> segment softmax over incoming edges -> head-averaged
    weights on the per-edge irrep messages -> segment sum;
  - gated pointwise activation: l=0 channels gate each l block.
The reference omits the rotation to and from the edge-aligned frame, so
SO(3) equivariance is approximate; so does the port. The segment sum runs
plain (`use_kernel=False`), as the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.gnn.egnn import graph_mean
from repro_torch.models.gnn.message_passing import rows, segment_softmax
from repro_torch.models.param import ParamSpec


@dataclasses.dataclass(frozen=True)
class EquiformerV2Config:
    n_layers: int = 12
    d_hidden: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_rbf: int = 16
    d_in: int = 16
    n_out: int = 7
    task: str = "node_classification"
    n_graphs: int = 1


def coeff_layout(l_max: int, m_max: int):
    """List of (l, m) in coefficient order + per-|m| index groups."""
    pairs = []
    for l in range(l_max + 1):
        mm = min(l, m_max)
        for m in range(-mm, mm + 1):
            pairs.append((l, m))
    groups = {}
    for i, (l, m) in enumerate(pairs):
        groups.setdefault(abs(m), []).append(i)
    return pairs, groups


def n_coeff(l_max: int, m_max: int) -> int:
    return len(coeff_layout(l_max, m_max)[0])


def param_specs(cfg: EquiformerV2Config) -> dict:
    C = cfg.d_hidden
    _, groups = coeff_layout(cfg.l_max, cfg.m_max)
    f32 = torch.float32

    def so2_block():
        # one separable weight per |m| block: l-mixing (k, k) x channel mixing (C, C)
        d = {}
        for m, idxs in groups.items():
            k = len(idxs)
            d[f"l_mix_{m}"] = ParamSpec((k, k), (None, None), dtype=f32)
            d[f"c_mix_{m}"] = ParamSpec((C, C), ("embed", "mlp"), dtype=f32)
        return d

    layer = lambda: {
        "so2": so2_block(),
        "rbf_w": ParamSpec((cfg.n_rbf, len(groups)), (None, None), dtype=f32),
        "attn_q": ParamSpec((C, cfg.n_heads), ("embed", "heads"), dtype=f32),
        "attn_k": ParamSpec((C, cfg.n_heads), ("embed", "heads"), dtype=f32),
        "gate_w": ParamSpec((C, (cfg.l_max + 1) * C), ("embed", "mlp"), dtype=f32),
        "out_mix": ParamSpec((C, C), ("mlp", "embed"), dtype=f32),
    }
    return {
        "encoder_w": ParamSpec((cfg.d_in, C), ("feat", "embed"), dtype=f32),
        "encoder_b": ParamSpec((C,), ("embed",), init="zeros", dtype=f32),
        "layers": [layer() for _ in range(cfg.n_layers)],
        "decoder_w": ParamSpec((C, cfg.n_out), ("embed", None), dtype=f32),
        "decoder_b": ParamSpec((cfg.n_out,), (None,), init="zeros", dtype=f32),
    }


def rbf_centers(n_rbf: int, cutoff: float = 5.0) -> np.ndarray:
    """The reference's `jnp.linspace(0, cutoff, n_rbf)` bit for bit. XLA
    compiles it to iota * (cutoff * (1 / (n - 1))), the constant folded in
    float32, with the stop appended; `torch.linspace` and `np.linspace`
    differ from it in last bits."""
    step = np.float32(cutoff) * (np.float32(1) / np.float32(n_rbf - 1))
    return np.append(np.arange(n_rbf - 1, dtype=np.float32) * step,
                     np.float32(cutoff)).astype(np.float32)


def _rbf(dist: torch.Tensor, n_rbf: int, cutoff: float = 5.0) -> torch.Tensor:
    mu = torch.from_numpy(rbf_centers(n_rbf, cutoff)).to(dist.device)
    beta = (n_rbf / cutoff) ** 2
    return torch.exp(-beta * (dist[:, None] - mu[None, :]) ** 2)


def forward(params: dict, batch: dict, cfg: EquiformerV2Config) -> torch.Tensor:
    """Node irreps (N, n_coeff, C)."""
    pairs, groups = coeff_layout(cfg.l_max, cfg.m_max)
    nc, C = len(pairs), cfg.d_hidden
    dev = batch["node_feat"].device
    n = batch["node_feat"].shape[0]

    # init irreps: l=0 from encoded features, higher l zero
    h0 = F.silu(batch["node_feat"] @ params["encoder_w"] + params["encoder_b"])
    x = torch.cat([h0[:, None, :], h0.new_zeros((n, nc - 1, C))], 1)

    src, dst = batch["src"].long(), batch["dst"].long()
    ok = (src >= 0) & (dst >= 0)
    s = torch.where(ok, src, 0)
    t = torch.where(ok, dst, 0)
    dstm = torch.where(ok, dst, -1)
    pos = batch["node_pos"].float()
    dist = torch.sqrt(torch.sum((rows(pos, t) - rows(pos, s)) ** 2, -1) + 1e-9)
    rbf = _rbf(dist, cfg.n_rbf)  # (E, n_rbf)

    blocks = sorted(groups.items())
    # out_msg's coefficients from the blocks laid end to end: one fixed
    # gather, so every block stays in the graph (the reference writes the
    # blocks into disjoint index groups that cover all nc coefficients)
    order = torch.tensor([i for _, idxs in blocks for i in idxs], device=dev)
    unpermute = torch.argsort(order)
    block_idx = [torch.tensor(idxs, device=dev) for _, idxs in blocks]
    l_of = torch.tensor([l for l, _ in pairs], device=dev)

    for lp in params["layers"]:
        # --- per-edge eSCN (SO(2)) convolution ---------------------------
        msg = rows(x, s)  # (E, nc, C) source irreps gathered per edge
        radial = F.silu(rbf @ lp["rbf_w"])  # (E, n_groups)
        out = []
        for gi, ((m, _), idx) in enumerate(zip(blocks, block_idx)):
            block = torch.einsum("ekc,kl->elc", torch.index_select(msg, 1, idx),
                                 lp["so2"][f"l_mix_{m}"])
            block = block @ lp["so2"][f"c_mix_{m}"]
            out.append(block * radial[:, gi, None, None])
        out_msg = torch.index_select(torch.cat(out, 1), 1, unpermute)

        # --- equivariant graph attention over edges ----------------------
        qi = rows(x[:, 0, :], t) @ lp["attn_q"]  # (E, H) invariant queries (dst)
        ki = out_msg[:, 0, :] @ lp["attn_k"]  # (E, H) invariant keys (msg)
        score = L.div(qi * ki, float(np.sqrt(C)))
        # bounded scores (softcap), as the reference
        score = 8.0 * torch.tanh(L.div(score, 8.0))
        alpha = segment_softmax(torch.where(ok[:, None], score, -torch.inf), dstm, n)
        alpha = torch.where(ok[:, None], alpha, 0.0)
        # head-average weighting (channels grouped across heads)
        w = L.div(torch.sum(alpha, -1), float(alpha.shape[-1]))[:, None, None]
        weighted = (out_msg * w).reshape(out_msg.shape[0], -1)  # (E, nc*C)
        aggv = ops.segment_sum(weighted, dstm, n, use_kernel=False).reshape(n, nc, C)

        # --- gated pointwise (S2-style) activation -----------------------
        gates = torch.sigmoid(aggv[:, 0, :] @ lp["gate_w"]).reshape(n, cfg.l_max + 1, C)
        x = x + (aggv * torch.index_select(gates, 1, l_of)) @ lp["out_mix"]
    return x


def loss_fn(params: dict, batch: dict, cfg: EquiformerV2Config) -> Tuple[torch.Tensor, dict]:
    x = forward(params, batch, cfg)
    out = x[:, 0, :] @ params["decoder_w"] + params["decoder_b"]  # invariant channel
    if cfg.task == "graph_regression":
        loss = L.mse(graph_mean(out, batch["graph_id"], cfg.n_graphs), batch["graph_targets"])
        return loss, {"mse": loss}
    loss = L.cross_entropy_loss(out, batch["labels"], batch.get("seed_mask"))
    return loss, {"ce": loss}
