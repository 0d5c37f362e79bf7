"""Mixture-of-Experts FFN with sort-based capacity dispatch (the
reference's `models/moe.py`, its single-device path).

Token -> expert dispatch is gRouting's query -> processor dispatch: router
scores, a finite capacity per destination, and each item's arrival rank
within its destination (`core.dispatch._rank_within`, which
`capacity_dispatch` ranks with too). MoE drops an assignment whose rank
reaches the capacity where gRouting steals.

`moe_ffn`, step by step as the reference:

  1. router top-k by float32 probability         (T, k)
  2. rank of each assignment within its expert; drop rank >= capacity
  3. scatter tokens into (E_padded, C, d) expert buffers
  4. the experts' SwiGLU as batched products over the expert axis
  5. combine: each assignment's output times its gate, summed per token

Ties. The reference's probabilities are XLA's, which flush subnormal
results to zero (on the TPU and on the CPU alike), and `jax.lax.top_k`
puts the lower expert index first among equal values. PyTorch keeps
subnormals, so `route` flushes them to zero, and takes the top k of a
stable descending sort. Then a token whose k-th and (k+1)-th probabilities
both underflow picks the lower index on every device.

No boolean-mask indexing and no `nonzero` on the path (each would be a
host sync a layer): dropped assignments are scattered into a dump row,
one expert row past the padded experts, that is sliced away. The k
contributions of a token are summed in k order in the output dtype, as
the reference's scatter-add does on the CPU; `index_add_` on CUDA would
add them by atomics, in another order from run to run.

The reference's expert-parallel path (`_moe_ffn_shard_map`, under a mesh
with a "model" axis) is not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.dispatch import _rank_within
from repro_torch.models import layers as L
from repro_torch.models.param import ParamSpec

FLT_MIN = torch.finfo(torch.float32).tiny  # the least normal float32


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    n_experts: int  # real experts (the router's width)
    n_experts_padded: int  # >= n_experts; the padded ones get no tokens
    top_k: int
    d_ff_expert: int
    d_ff_shared: int = 0  # 0: no shared expert
    capacity_factor: float = 1.25
    dtype: torch.dtype = torch.bfloat16


def moe_param_specs(cfg: MoEConfig) -> dict:
    E, d, fe = cfg.n_experts_padded, cfg.d_model, cfg.d_ff_expert
    specs = {
        "router": ParamSpec((d, cfg.n_experts), ("embed", None), dtype=torch.float32),
        "w_gate": ParamSpec((E, d, fe), ("experts", "embed", "mlp"), dtype=cfg.dtype),
        "w_up": ParamSpec((E, d, fe), ("experts", "embed", "mlp"), dtype=cfg.dtype),
        "w_down": ParamSpec((E, fe, d), ("experts", "mlp", "embed"), dtype=cfg.dtype),
    }
    if cfg.d_ff_shared:
        fs = cfg.d_ff_shared
        specs["shared"] = {
            "w_gate": ParamSpec((d, fs), ("embed", "mlp"), dtype=cfg.dtype),
            "w_up": ParamSpec((d, fs), ("embed", "mlp"), dtype=cfg.dtype),
            "w_down": ParamSpec((fs, d), ("mlp", "embed"), dtype=cfg.dtype),
        }
    return specs


def expert_capacity(n_tokens: int, cfg: MoEConfig) -> int:
    """Slots an expert: ceil(T k / E * capacity_factor) in Python floats,
    rounded up to a multiple of 8, at least 8."""
    c = int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)


class Routing(NamedTuple):
    probs: torch.Tensor  # (T, E) float32, subnormals flushed to 0
    idx: torch.Tensor  # (T, k) int64 experts, by probability, ties to the lower index
    gates: torch.Tensor  # (T, k) float32, renormalised over the k
    rank: torch.Tensor  # (T k,) int64 arrival rank within the expert, token-major
    keep: torch.Tensor  # (T k,) bool, rank < capacity
    dest_e: torch.Tensor  # (T k,) int64 expert row, E_padded (the dump row) if dropped
    dest_c: torch.Tensor  # (T k,) int64 slot, 0 if dropped
    capacity: int


def route(router: torch.Tensor, x: torch.Tensor, cfg: MoEConfig,
          capacity: Optional[int] = None) -> Routing:
    """Steps 1-2 of `moe_ffn` for tokens x (T, d) and the router (d, E)."""
    Ep, k = cfg.n_experts_padded, cfg.top_k
    if capacity is None:
        capacity = expert_capacity(x.shape[0], cfg)
    probs = torch.softmax(x.float() @ router, dim=-1)
    probs.masked_fill_(probs < FLT_MIN, 0.0)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :k], idx[:, :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    flat_e = idx.reshape(-1)
    rank = _rank_within(flat_e)
    keep = rank < capacity
    dest_e = torch.where(keep, flat_e, Ep)
    dest_c = torch.where(keep, rank, 0)
    return Routing(probs, idx, gates, rank, keep, dest_e, dest_c, capacity)


def aux_loss(r: Routing) -> torch.Tensor:
    """The Switch load-balance loss E * sum_e f_e p_e of one layer's routing,
    () float32; the counts are exact in float32. Only the loss reads it, so
    serving never computes it."""
    (T, E), k = r.probs.shape, r.idx.shape[1]
    me = L.div(r.probs.sum(0), float(T))
    counts = torch.zeros(E, dtype=torch.int64, device=r.probs.device)
    counts.scatter_add_(0, r.idx.reshape(-1), torch.ones_like(r.idx.reshape(-1)))
    ce = L.div(counts.float(), float(T * k))
    return E * torch.sum(me * ce)


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig,
            capacity: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, d) tokens (a flattened batch, row-major) -> (out (T, d) in x's
    dtype, aux () float32). `params`: the reference's tree (`router`,
    `w_gate`, `w_up`, `w_down`, and `shared` when d_ff_shared > 0)."""
    out, r = moe_routed(params, x, cfg, capacity)
    return out, aux_loss(r)


def moe_routed(params: dict, x: torch.Tensor, cfg: MoEConfig,
               capacity: Optional[int] = None) -> Tuple[torch.Tensor, Routing]:
    """`moe_ffn` with the layer's `Routing` in place of the aux loss."""
    T, d = x.shape
    Ep, k = cfg.n_experts_padded, cfg.top_k
    r = route(params["router"], x, cfg, capacity)
    C = r.capacity
    slot = r.dest_e * C + r.dest_c  # (T k,); dropped ones share the dump slot
    buf = x.new_zeros(((Ep + 1) * C, d))
    buf[slot] = x[:, None, :].expand(T, k, d).reshape(T * k, d)
    buf = buf.view(Ep + 1, C, d)[:Ep]

    h = torch.bmm(buf, params["w_gate"])
    u = torch.bmm(buf, params["w_up"])
    y = torch.bmm(F.silu(h) * u, params["w_down"]).view(Ep * C, d)

    gate = torch.where(r.keep, r.gates.reshape(-1), 0.0).to(y.dtype)
    read = r.dest_e.clamp(max=Ep - 1) * C + r.dest_c  # a dropped one reads row Ep - 1
    contrib = (y[read] * gate[:, None]).view(T, k, d)
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    if cfg.d_ff_shared:
        s = params["shared"]
        out = out + L.swiglu(x, s["w_gate"], s["w_up"], s["w_down"])
    return out.to(x.dtype), r


def _frozen(x: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(x, requires_grad=False)


class MoE(nn.Module):
    """One layer's MoE FFN under the reference's parameter names (`router`,
    `w_gate`, `w_up`, `w_down`, `shared.{w_gate, w_up, w_down}`)."""

    def __init__(self, p: dict, cfg: MoEConfig):
        super().__init__()
        self.cfg = cfg
        for name in ("router", "w_gate", "w_up", "w_down"):
            setattr(self, name, _frozen(p[name]))
        self.shared = nn.ParameterDict({n: _frozen(v) for n, v in p["shared"].items()}) \
            if "shared" in p else None

    def tree(self) -> dict:
        """The reference's nested tree of this FFN."""
        t = {n: getattr(self, n) for n in ("router", "w_gate", "w_up", "w_down")}
        if self.shared is not None:
            t["shared"] = dict(self.shared)
        return t

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Routing]:
        return moe_routed(self.tree(), x, self.cfg)
