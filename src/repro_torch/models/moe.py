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

Expert parallelism (`moe_ffn_expert_parallel`, the reference's
`_moe_ffn_shard_map`): under rules (`set_mesh_rules`) whose mesh is a
`ProcessMesh` with a "model" axis above 1, `moe_routed` (and with it
`moe_ffn` and the `MoE` module) takes that path, as the reference's
`moe_ffn` does. Every argument is then this rank's block, as in a shard_map
body: x its data shard's tokens, the parameters its shards
(`moe_local_params`). Activations are replicated along "model": each model
rank routes its tokens redundantly, scatters only those bound for its
E_padded / n_model resident experts, and one psum over "model" combines.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.dispatch import _rank_within
from repro_torch.distributed import collectives as C
from repro_torch.distributed.mesh_utils import current_rules, local_shard, mesh_axes
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
    """One layer's routing. Under expert parallelism it is this rank's: T
    counts the tokens it routed (its data shard's, or every data shard's in
    the weight-stationary regime), and `probs`, `idx`, `gates`, `rank` and
    `keep` are the same on every model rank (so the per-layer checks of
    drops, the busiest expert and ties read them as on one device), while
    `dest_e` / `dest_c` address the rank's resident experts (E_padded /
    n_model rows, the dump row past them) and `aux` holds the layer's
    load-balance loss, averaged over the data axes."""

    probs: torch.Tensor  # (T, E) float32, subnormals flushed to 0
    idx: torch.Tensor  # (T, k) int64 experts, by probability, ties to the lower index
    gates: torch.Tensor  # (T, k) float32, renormalised over the k
    rank: torch.Tensor  # (T k,) int64 arrival rank within the expert, token-major
    keep: torch.Tensor  # (T k,) bool, rank < capacity
    dest_e: torch.Tensor  # (T k,) int64 expert row, E_padded (the dump row) if dropped
    dest_c: torch.Tensor  # (T k,) int64 slot, 0 if dropped
    capacity: int
    aux: Optional[torch.Tensor] = None  # expert parallel only: the layer's aux loss


def route(router: torch.Tensor, x: torch.Tensor, cfg: MoEConfig,
          capacity: Optional[int] = None) -> Routing:
    """Steps 1-2 of `moe_ffn` for tokens x (T, d) and the router (d, E)."""
    Ep, k = cfg.n_experts_padded, cfg.top_k
    if capacity is None:
        capacity = expert_capacity(x.shape[0], cfg)
    probs = torch.softmax(x.float() @ router, dim=-1)
    probs = probs.masked_fill(probs < FLT_MIN, 0.0)  # not in place: softmax's backward reads it
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
    serving never computes it. Under expert parallelism, the loss that
    path computed."""
    if r.aux is not None:
        return r.aux
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
    """`moe_ffn` with the layer's `Routing` in place of the aux loss. Under
    rules whose mesh has a "model" axis above 1, the expert-parallel path."""
    mesh = expert_parallel_mesh()
    if mesh is not None:
        return moe_ffn_expert_parallel(params, x, cfg, mesh, capacity)
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


# ---------------------------------------------------------------------------
# expert parallelism over the mesh's "model" axis (`_moe_ffn_shard_map`)
# ---------------------------------------------------------------------------


def expert_parallel_mesh():
    """The current rules' mesh where the reference's `moe_ffn` takes its
    shard_map path (a "model" axis above 1), else None."""
    lr = current_rules()
    if lr is not None and mesh_axes(lr.mesh).get("model", 1) > 1:
        return lr.mesh
    return None


def moe_shard_specs(cfg: MoEConfig, mesh) -> dict:
    """The reference's shard_map `in_specs` of the parameters: experts over
    "model", the FSDP dims over "data" where the mesh has it, the shared
    expert's d_ff over "model"."""
    fsdp = "data" if "data" in mesh_axes(mesh) else None
    specs = {"router": (fsdp, None), "w_gate": ("model", fsdp, None),
             "w_up": ("model", fsdp, None), "w_down": ("model", None, fsdp)}
    if cfg.d_ff_shared:
        specs["shared"] = {"w_gate": (fsdp, "model"), "w_up": (fsdp, "model"),
                           "w_down": ("model", fsdp)}
    return specs


def moe_local_params(params: dict, cfg: MoEConfig, mesh) -> dict:
    """This rank's shards of an MoE FFN's full tree (`local_shard`)."""
    specs = moe_shard_specs(cfg, mesh)
    out = {k: local_shard(params[k], specs[k], mesh) for k in ("router", "w_gate", "w_up",
                                                              "w_down")}
    if cfg.d_ff_shared:
        out["shared"] = {k: local_shard(v, specs["shared"][k], mesh)
                         for k, v in params["shared"].items()}
    return out


def _slice(x: torch.Tensor, dim: int, i: int, n: int) -> torch.Tensor:
    size = x.shape[dim] // n
    return x.narrow(dim, i * size, size)


def moe_ffn_expert_parallel(params: dict, x: torch.Tensor, cfg: MoEConfig, mesh,
                            capacity: Optional[int] = None) -> Tuple[torch.Tensor, Routing]:
    """Expert-parallel MoE on a `ProcessMesh` with a "model" axis, without a
    token all_to_all; every rank of the mesh calls it at once.

    x (T_loc, d): this data shard's tokens (data shards over "pod" and
    "data"), the same on every model rank. `params`: this rank's shards
    (`moe_local_params`): E_loc = E_padded / n_model resident experts, the
    FSDP dims split over "data". Capacity is a data shard's: ceil(T_loc k
    / E * capacity_factor) rounded up to 8. Returns (out (T_loc, d) in x's
    dtype, this rank's `Routing` with the aux loss).

    Two regimes, as the reference's: with T_loc k > 64 the weight shards are
    all-gathered over "data" (FSDP); with T_loc k <= 64 (decode) the weights
    stay: the tokens are gathered over "data", each rank contracts its
    d-slice, the partial activations are psum'd, and the rank's tokens are
    sliced back out. Inputs replicated along an axis `enter` it
    (`collectives`), so the gradients are the reference's."""
    axes = mesh_axes(mesh)
    data_axes = tuple(a for a in ("pod", "data") if a in axes)
    fsdp = "data" in axes
    n_model, n_fsdp = axes["model"], axes.get("data", 1)
    E, Ep, k = cfg.n_experts, cfg.n_experts_padded, cfg.top_k
    if Ep % n_model:
        raise ValueError(f"{Ep} experts over a model axis of {n_model}")
    E_loc = Ep // n_model
    T_loc, d = x.shape
    cap = capacity if capacity is not None else expert_capacity(T_loc, cfg)
    ws = fsdp and T_loc * k <= 64  # weight-stationary (decode)
    g_model = mesh.group("model")
    g_fsdp = mesh.group("data") if fsdp else None
    di = mesh.axis_index("data") if fsdp else 0

    x_in = C.enter(x, g_model)
    router = C.enter(params["router"], g_model)
    wg, wu, wd = params["w_gate"], params["w_up"], params["w_down"]
    if fsdp:
        router = C.all_gather(router, g_fsdp, 0)
    if ws:
        x_eff, cap_eff = C.all_gather(x_in, g_fsdp, 0), cap * n_fsdp
    else:
        x_eff, cap_eff = x_in, cap
        if fsdp:
            wg, wu = C.all_gather(wg, g_fsdp, 1), C.all_gather(wu, g_fsdp, 1)
            wd = C.all_gather(wd, g_fsdp, 2)
    T = x_eff.shape[0]
    r = route(router, x_eff, cfg, cap_eff)
    aux = aux_loss(r)
    if data_axes:
        aux = C.pmean(aux, mesh.group(data_axes))
    aux = C.invariant(aux, g_model)  # computed alike on every model rank

    lo = mesh.axis_index("model") * E_loc
    flat_e = r.idx.reshape(-1)
    mine = r.keep & (flat_e >= lo) & (flat_e < lo + E_loc)
    dest_e = torch.where(mine, flat_e - lo, E_loc)  # others to the dump row
    dest_c = torch.where(mine, r.rank, 0)
    slot = dest_e * cap_eff + dest_c
    buf = x_eff.new_zeros(((E_loc + 1) * cap_eff, d))
    buf[slot] = x_eff[:, None, :].expand(T, k, d).reshape(T * k, d)
    buf = buf.view(E_loc + 1, cap_eff, d)[:E_loc]
    if ws:
        # each rank's d-slice; h and u then meet its own d-slice of w_down
        buf = _slice(buf, 2, di, n_fsdp)
        h = C.enter(C.psum(torch.bmm(buf, wg), g_fsdp), g_fsdp)
        u = C.enter(C.psum(torch.bmm(buf, wu), g_fsdp), g_fsdp)
        y = C.all_gather(torch.bmm(F.silu(h) * u, wd), g_fsdp, 2)
    else:
        y = torch.bmm(F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu), wd)
    y = y.reshape(E_loc * cap_eff, d)

    gate = torch.where(mine, r.gates.reshape(-1), 0.0).to(y.dtype)
    read = dest_e.clamp(max=E_loc - 1) * cap_eff + dest_c
    contrib = (y[read] * gate[:, None]).view(T, k, d)
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    if cfg.d_ff_shared:  # d_ff split over "model"
        sg, su, sd = (params["shared"][n] for n in ("w_gate", "w_up", "w_down"))
        if ws:
            xs = _slice(x_eff, 1, di, n_fsdp)
            hs = C.enter(C.psum(xs @ sg, g_fsdp), g_fsdp)
            us = C.enter(C.psum(xs @ su, g_fsdp), g_fsdp)
            out = out + C.all_gather((F.silu(hs) * us) @ sd, g_fsdp, 1)
        else:
            if fsdp:
                sg, su = C.all_gather(sg, g_fsdp, 0), C.all_gather(su, g_fsdp, 0)
                sd = C.all_gather(sd, g_fsdp, 1)
            out = out + L.swiglu(x_eff, sg, su, sd)
    out = C.psum(out, g_model)
    if ws:
        out = _slice(out, 0, di, n_fsdp)
    return out.to(x.dtype), r._replace(dest_e=dest_e, dest_c=dest_c, aux=aux)


def _frozen(x: torch.Tensor) -> nn.Parameter:
    """As `transformer._param`: a `nn.Parameter` (a training state's leaf)
    is held as it is, any other tensor frozen."""
    return x if isinstance(x, nn.Parameter) else nn.Parameter(x, requires_grad=False)


class MoE(nn.Module):
    """One layer's MoE FFN under the reference's parameter names (`router`,
    `w_gate`, `w_up`, `w_down`, `shared.{w_gate, w_up, w_down}`). Under
    expert parallelism it holds this rank's shards (`moe_local_params`)."""

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
