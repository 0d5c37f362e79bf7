"""Decoder-only LM: prefill and decode (the reference's
`models/transformer.py`).

Per-architecture flags in `LMConfig`: GQA, QKV bias (qwen2.5), per-head qk
RMS norm (qwen3), alternating local (sliding-window) / global layers,
attention and final logit softcaps, post-norms and embedding scaling
(gemma2), MoE FFNs with a shared expert (qwen2-moe) or without (dbrx):
`n_experts > 0`, `models/moe.py`.

Training: `loss_fn` (the module-level function over a parameter tree, and
the `Transformer` method) is the reference's differentiable loss: the
trunk, then the seq-chunked unembed + cross-entropy head, plus 0.01 times
the MoE layers' load-balance loss. With `cfg.remat` each layer group runs
under `torch.utils.checkpoint`, so the backward recomputes a group from its
saved input. The serving entry points stay under `torch.no_grad`.

Parameters keep the reference's `(in, out)` layout (`x @ W`). The
reference stacks each layer parameter along a leading `stack` axis, one
tree per position in `pattern`; `lm_param_specs` gives that same tree, and
`Transformer` holds it unstacked, one `Layer` per layer: layer `li` is
group `li // len(pattern)` at pattern index `li % len(pattern)`
(`unstack_layers` / `stack_layers`).

The decode cache is a list of per-layer {"k", "v": (B, Hkv, Smax, Dh),
"pos": int}. `serve_step` writes the new keys and values into it IN PLACE
(a functional update would copy the whole cache every step) and returns
it with `pos` advanced; `pos` is a Python int, so slicing needs no sync.

On a mesh (`MeshLayout`): the reference binds its step to a mesh and lets
GSPMD write the collectives (`configs/base.py` `bind_rules`,
`LM_TRAIN_RULES`). Here `loss_fn` and `prefill_forward` given a layout run
per rank, on this rank's shards of the port's tree (`lm_local_pspecs`,
`models.param.local_params`) and its batch rows, every rank at once:

  - FSDP: each weight is gathered over the batch axes it is split on
    before use (`mesh_utils.gather`, whose backward is a reduce-scatter);
  - attention and the FFN are column-parallel then row-parallel over
    "model" (q / k / v and w_gate / w_up on this rank's columns, wo and
    w_down on its rows), closed by a psum; the activation entering such a
    block enters "model";
  - the rank's q heads are its block of heads where the q activation's
    spec splits heads over "model" (`transformer.py:207` in the
    reference), else every head; its k / v heads are the slice those q
    heads read, so the kernel's own GQA mapping holds (one kv head shared
    by several ranks when a rank has fewer q heads than a group; the kv
    heads repeated a q head when neither divides the other);
  - the embedding and the loss head are vocab-parallel: a rank looks up
    and scores only its vocab rows (`layers.chunked_unembed_xent` with a
    group);
  - every leaf enters the batch axes it is not split on (its use differs
    with the rows), and a leaf the spec replicates along "model" enters
    "model" where it meets one rank's share (q_norm and k_norm, or a block
    sliced from a whole leaf); the norms around a block, applied alike on
    every model rank, do not;
  - the MoE FFN is `moe_ffn_expert_parallel`, whose in_specs the leaves'
    resolved specs must equal.

`serve_step` given a layout is the reference's decode step bound to a mesh
under `LM_DECODE_RULES` (the cache's `kv_seq` over "model") or
`LM_LONG_DECODE_RULES` (the batch whole, `kv_seq` over ("data", "model")),
`kv_heads` whole under both: a rank holds one block of the positions of
every kv head of its rows (`local_kv_cache`). Its attention
(`_mesh_decode_attention`) needs every q head: it computes the q columns
of its shard of wq and all-gathers the activation over "model". Only the
rank whose block holds `pos` writes the new keys and values; the masks are
in global positions, so a block that is wholly masked joins every
collective with the finite MASK_VALUE. The softmax runs over the sharded
keys as the reference's does (the row max over the `kv_seq` group, the
local sums of exp, their psum, probabilities cast to the model's dtype
before the product with the rank's v block), and the partial outputs are
summed over the group in float32, then cast once.

A block whose inner dim the specs leave whole along "model" (e.g. a d_ff
that does not split) runs alike on every model rank, with no enter and no
psum.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import collectives as C
from repro_torch.distributed.mesh_utils import (
    DEFAULT_RULES, LogicalRules, gather, layout as spec_layout, mesh_axes, resolve_pspec,
    split_axes,
)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import MASK_VALUE
from repro_torch.models import layers as L
from repro_torch.models.moe import MoE, MoEConfig, Routing, aux_loss, moe_ffn_expert_parallel, \
    moe_local_params, moe_param_specs, moe_shard_specs
from repro_torch.models.param import ParamSpec, init_params, param_pspecs, tree_map, \
    tree_map_with


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # MoE (n_experts == 0: dense)
    n_experts: int = 0
    n_experts_padded: int = 0  # 0: n_experts
    top_k: int = 0
    d_ff_expert: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    # attention flavour
    qkv_bias: bool = False
    qk_norm: bool = False
    window: Optional[int] = None  # sliding window of the local layers
    pattern: Tuple[str, ...] = ("global",)  # layer kinds of one group
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    embed_scale: bool = False  # gemma: embeddings * sqrt(d_model)
    post_norms: bool = False  # gemma2: post-attention / post-FFN norms
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True  # training: recompute each layer group in the backward
    grad_accum: int = 1  # training: microbatches per train step
    xent_chunk: int = 512  # training: seq chunk of the unembed + CE loss head
    attn_chunk: bool = True  # plain attention by q chunks for long sequences

    @property
    def moe(self) -> bool:
        return self.n_experts > 0

    @property
    def group_size(self) -> int:
        return len(self.pattern)

    @property
    def n_groups(self) -> int:
        if self.n_layers % self.group_size:
            raise ValueError(f"{self.n_layers} layers do not divide into groups "
                             f"of {self.group_size}")
        return self.n_layers // self.group_size

    def moe_cfg(self) -> MoEConfig:
        return MoEConfig(d_model=self.d_model, n_experts=self.n_experts,
                         n_experts_padded=self.n_experts_padded or self.n_experts,
                         top_k=self.top_k, d_ff_expert=self.d_ff_expert,
                         d_ff_shared=self.d_ff_shared, capacity_factor=self.capacity_factor,
                         dtype=self.dtype)


# ---------------------------------------------------------------------------
# parameter specs (the reference's tree, stacked per pattern index)
# ---------------------------------------------------------------------------


def _stacked(spec: ParamSpec, n: int) -> ParamSpec:
    return ParamSpec((n,) + spec.shape, ("stack",) + spec.axes, spec.init, spec.scale,
                     spec.dtype)


def _attn_specs(cfg: LMConfig) -> dict:
    d, H, Hk, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = {
        "wq": ParamSpec((d, H * Dh), ("embed", "heads"), dtype=cfg.dtype),
        "wk": ParamSpec((d, Hk * Dh), ("embed", "kv_heads"), dtype=cfg.dtype),
        "wv": ParamSpec((d, Hk * Dh), ("embed", "kv_heads"), dtype=cfg.dtype),
        "wo": ParamSpec((H * Dh, d), ("heads", "embed"), dtype=cfg.dtype),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((H * Dh,), ("heads",), init="zeros", dtype=cfg.dtype)
        s["bk"] = ParamSpec((Hk * Dh,), ("kv_heads",), init="zeros", dtype=cfg.dtype)
        s["bv"] = ParamSpec((Hk * Dh,), ("kv_heads",), init="zeros", dtype=cfg.dtype)
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec((Dh,), ("head_dim",), init="zeros", dtype=torch.float32)
        s["k_norm"] = ParamSpec((Dh,), ("head_dim",), init="zeros", dtype=torch.float32)
    return s


def _ffn_specs(cfg: LMConfig) -> dict:
    if cfg.moe:
        return moe_param_specs(cfg.moe_cfg())
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamSpec((d, f), ("embed", "mlp"), dtype=cfg.dtype),
        "w_up": ParamSpec((d, f), ("embed", "mlp"), dtype=cfg.dtype),
        "w_down": ParamSpec((f, d), ("mlp", "embed"), dtype=cfg.dtype),
    }


def _norm_spec(cfg: LMConfig) -> ParamSpec:
    return ParamSpec((cfg.d_model,), ("embed",), init="zeros", dtype=torch.float32)


def _layer_specs(cfg: LMConfig) -> dict:
    s = {"attn": _attn_specs(cfg), "ffn": _ffn_specs(cfg),
         "input_norm": _norm_spec(cfg), "post_attn_norm": _norm_spec(cfg)}
    if cfg.post_norms:
        s["post_attn_out_norm"] = _norm_spec(cfg)
        s["post_ffn_norm"] = _norm_spec(cfg)
    return s


def lm_param_specs(cfg: LMConfig) -> dict:
    """The reference's spec tree: {"embed", "layers": {pattern index: layer
    specs stacked (n_groups, ...)}, "final_norm", "unembed"}."""
    return {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"), scale=1.0,
                           dtype=cfg.dtype),
        "layers": {str(i): tree_map(lambda s: _stacked(s, cfg.n_groups), _layer_specs(cfg))
                   for i in range(cfg.group_size)},
        "final_norm": _norm_spec(cfg),
        "unembed": ParamSpec((cfg.d_model, cfg.vocab), ("embed", "vocab"), dtype=cfg.dtype),
    }


def unstack_layers(tree: dict, cfg: LMConfig) -> dict:
    """Stacked tree -> the same tree with "layers" a list of per-layer trees
    (views of the stacked leaves)."""
    G = cfg.group_size
    layers = [tree_map(lambda a: a[li // G], tree["layers"][str(li % G)])
              for li in range(cfg.n_layers)]
    return {**tree, "layers": layers}


def stack_layers(tree: dict, cfg: LMConfig) -> dict:
    """Inverse of `unstack_layers` (the stacked leaves are new tensors)."""
    def stack(trees: list):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    G = cfg.group_size
    return {**tree, "layers": {str(i): stack(tree["layers"][i::G]) for i in range(G)}}


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def expert_parallel_params(tree: dict, cfg: LMConfig, mesh) -> dict:
    """The port's tree (one tree a layer) with each MoE FFN cut to this
    rank's shards (`moe.moe_local_params`); every other leaf stays whole,
    replicated on every rank as the reference's attention is along
    "model". A `Transformer` of it runs under `set_mesh_rules(mesh)`."""
    if not cfg.moe:
        return tree
    moe = cfg.moe_cfg()
    layers = [dict(lp, ffn=moe_local_params(lp["ffn"], moe, mesh)) for lp in tree["layers"]]
    return dict(tree, layers=layers)


def _param(x: torch.Tensor) -> nn.Parameter:
    """A parameter of the tree: one that is already a `nn.Parameter` (a
    training state's leaf) is held as it is, so gradients reach it; any
    other tensor is held frozen, as serving holds it."""
    return x if isinstance(x, nn.Parameter) else nn.Parameter(x, requires_grad=False)


class Layer(nn.Module):
    """One decoder layer's parameters, under the reference's names; an MoE
    layer's FFN is an `MoE` module (its `shared` subtree nests)."""

    def __init__(self, p: dict, kind: str, moe: Optional[MoEConfig] = None):
        super().__init__()
        self.kind = kind  # local | global
        self.attn = nn.ParameterDict({k: _param(v) for k, v in p["attn"].items()})
        self.ffn = MoE(p["ffn"], moe) if moe is not None else \
            nn.ParameterDict({k: _param(v) for k, v in p["ffn"].items()})
        self.norms = nn.ParameterDict(
            {k: _param(v) for k, v in p.items() if k not in ("attn", "ffn")})

    def tree(self) -> dict:
        ffn = self.ffn.tree() if isinstance(self.ffn, MoE) else dict(self.ffn)
        return {"attn": dict(self.attn), "ffn": ffn, **dict(self.norms)}


class Transformer(nn.Module):
    """The LM's parameters and its serving functions: `forward`, `trunk`,
    `prefill_forward`, `init_kv_cache`, `serve_step`.

    `params` is the port's tree (`unstack_layers` of the reference's, e.g.
    from `repro_torch.convert.lm_params_from_reference`); without it the
    parameters are drawn by `init_params` from `generator` on `device`
    (CUDA unless the caller asks for the CPU)."""

    def __init__(self, cfg: LMConfig, params: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        if params is None:
            params = unstack_layers(init_params(lm_param_specs(cfg), generator, dev), cfg)
        else:
            params = tree_map(lambda a: a.to(dev), params)
        if len(params["layers"]) != cfg.n_layers:
            raise ValueError(f"{len(params['layers'])} layers for {cfg.n_layers}")
        self.cfg = cfg
        self.embed = _param(params["embed"])
        self.final_norm = _param(params["final_norm"])
        self.unembed = _param(params["unembed"])
        moe = cfg.moe_cfg() if cfg.moe else None
        self.layers = nn.ModuleList(Layer(p, cfg.pattern[li % cfg.group_size], moe)
                                    for li, p in enumerate(params["layers"]))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def tree(self) -> dict:
        """The parameters as the port's tree (per-layer list)."""
        return {"embed": self.embed.data, "final_norm": self.final_norm.data,
                "unembed": self.unembed.data,
                "layers": [tree_map(lambda p: p.data, lp.tree()) for lp in self.layers]}

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = F.embedding(tokens.long(), self.embed).to(self.cfg.dtype)
        if self.cfg.embed_scale:
            s = torch.tensor(np.sqrt(self.cfg.d_model).astype(np.float32), device=x.device)
            x = x * s.to(self.cfg.dtype)
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return L.softcap((x @ self.unembed).float(), self.cfg.final_softcap)

    def _run_layers(self, tokens: torch.Tensor,
                    kvs: Optional[list] = None) -> Tuple[torch.Tensor, list]:
        """(x after the final norm, the MoE layers' `Routing`s in layer order)."""
        B, S = tokens.shape
        x = self._embed(tokens)
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
        routings = []
        for lp in self.layers:
            x, r, kv = _layer(lp, x, self.cfg, positions)
            if r is not None:
                routings.append(r)
            if kvs is not None:
                kvs.append(kv)
        return L.rms_norm(x, self.final_norm, self.cfg.norm_eps), routings

    def loss_fn(self, tokens: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, dict]:
        """The reference's `loss_fn`, differentiable: tokens and labels (B, S)
        -> (ce + 0.01 * aux, {"ce", "aux"}), ce the mean NLL of the chunked
        loss head (`cfg.xent_chunk`), aux as `trunk`'s. Each layer group
        runs under `torch.utils.checkpoint` when `cfg.remat` is set."""
        cfg = self.cfg
        B, S = tokens.shape
        x = self._embed(tokens)
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
        aux = torch.zeros((), device=x.device)
        G = cfg.group_size
        for g in range(cfg.n_groups):
            group = self.layers[g * G:(g + 1) * G]
            if cfg.remat:
                x, aux = checkpoint(self._group, group, x, aux, positions, use_reentrant=False)
            else:
                x, aux = self._group(group, x, aux, positions)
        x = L.rms_norm(x, self.final_norm, cfg.norm_eps)
        ce = L.chunked_unembed_xent(x, self.unembed, labels, cap=cfg.final_softcap,
                                    chunk=cfg.xent_chunk)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    def _group(self, group, x: torch.Tensor, aux: torch.Tensor,
               positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One layer group (the reference's scan step), the MoE aux added."""
        for lp in group:
            x, r, _ = _layer(lp, x, self.cfg, positions)
            if r is not None:
                aux = aux + aux_loss(r)
        return x, aux

    @torch.no_grad()
    def trunk(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Embed + layers + final norm: tokens (B, S) -> (x (B, S, d), aux:
        the float32 sum of the layers' MoE load-balance losses, in layer
        order; 0 for a dense LM)."""
        x, routings = self._run_layers(tokens)
        aux = torch.zeros((), device=x.device)
        for r in routings:
            aux = aux + aux_loss(r)
        return x, aux

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S) -> (float32 logits (B, S, V), aux as `trunk`)."""
        x, aux = self.trunk(tokens)
        return self._logits(x), aux

    @torch.no_grad()
    def prefill_forward(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, dict]:
        """tokens (B, S) -> (last-position logits (B, V), KV stack
        {pattern index: {"k", "v": (n_groups, B, Hkv, S, Dh)}})."""
        kvs: list = []
        x, _ = self._run_layers(tokens, kvs)
        G = self.cfg.group_size
        stack = {str(i): {n: torch.stack([kv[n] for kv in kvs[i::G]]) for n in ("k", "v")}
                 for i in range(G)}
        return self._logits(x[:, -1:, :])[:, 0], stack

    def init_kv_cache(self, batch: int, max_seq: int,
                      dtype: Optional[torch.dtype] = None) -> dict:
        """Zeroed per-layer decode caches on the model's device, pos 0."""
        dtype = dtype or self.cfg.dtype
        shape = (batch, self.cfg.n_kv_heads, max_seq, self.cfg.head_dim)
        return {"layers": [{"k": torch.zeros(shape, dtype=dtype, device=self.device),
                            "v": torch.zeros(shape, dtype=dtype, device=self.device),
                            "pos": 0} for _ in range(self.cfg.n_layers)]}

    @torch.no_grad()
    def serve_step(self, kv_cache: dict, tokens: torch.Tensor) -> Tuple[torch.Tensor, dict]:
        """One decode step: tokens (B, S) new ids -> (logits (B, V) of the last,
        the cache updated in place with pos advanced by S)."""
        B, S = tokens.shape
        x = self._embed(tokens)
        new_layers = []
        for lp, cache in zip(self.layers, kv_cache["layers"]):
            positions = (cache["pos"] + torch.arange(S, device=x.device))[None, :].expand(B, S)
            x, _, new_cache = _layer(lp, x, self.cfg, positions, kv_cache=cache)
            new_layers.append(new_cache)
        x = L.rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return self._logits(x[:, -1:, :])[:, 0], {"layers": new_layers}


def abstract_kv_cache(cfg: LMConfig, batch: int, max_seq: int,
                      dtype: Optional[torch.dtype] = None) -> dict:
    """`Transformer.init_kv_cache`'s cache as `meta` tensors, pos 0."""
    shape = (batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
    kv = lambda: torch.empty(shape, dtype=dtype or cfg.dtype, device="meta")
    return {"layers": [{"k": kv(), "v": kv(), "pos": 0} for _ in range(cfg.n_layers)]}


def kv_cache_pspecs(cfg: LMConfig, batch: int, max_seq: int, lr=None) -> dict:
    """The decode cache's sharding specs (`distributed.mesh_utils`)."""
    from repro_torch.distributed.mesh_utils import resolve_pspec

    kv = resolve_pspec(("batch", "kv_heads", "kv_seq", None),
                       (batch, cfg.n_kv_heads, max_seq, cfg.head_dim), lr)
    return {"layers": [{"k": kv, "v": kv, "pos": ()} for _ in range(cfg.n_layers)]}


def local_kv_cache(cfg: LMConfig, batch: int, max_seq: int, layout: "MeshLayout",
                   dtype: Optional[torch.dtype] = None, device: DeviceLike = None) -> dict:
    """This rank's zeroed block of `Transformer.init_kv_cache`'s cache on a
    mesh, pos 0: (B_loc, Hkv, Smax / n_seq, Dh) a layer, as
    `kv_cache_pspecs` resolves under the layout's rules, on `device` (CUDA
    unless the caller names another). Every rank builds it alike. Raises
    where the batch or the length does not split over the axes the rules
    give them, or the rules split the kv heads: the decode step on a mesh
    reads every kv head of its block of positions."""
    spec = kv_cache_pspecs(cfg, batch, max_seq, layout.lr)["layers"][0]["k"]
    if tuple(spec[:3]) != (layout.kv_spec[0], None, layout.kv_spec[2]):
        raise ValueError(f"a cache of batch {batch}, {cfg.n_kv_heads} kv heads and length "
                         f"{max_seq} resolves to {spec}; the decode step on a mesh takes "
                         f"{layout.kv_spec[0]} on the batch, the kv heads whole and "
                         f"{layout.kv_spec[2]} on the positions")
    shape = [batch, cfg.n_kv_heads, max_seq, cfg.head_dim]
    for dim, entry in enumerate(spec):
        if entry is not None:
            shape[dim] //= layout.mesh.axis_size(entry)
    dev = resolve_device(device)
    kv = lambda: torch.zeros(shape, dtype=dtype or cfg.dtype, device=dev)
    return {"layers": [{"k": kv(), "v": kv(), "pos": 0} for _ in range(cfg.n_layers)]}


def loss_fn(params: dict, batch: dict, cfg: LMConfig,
            layout: Optional["MeshLayout"] = None) -> Tuple[torch.Tensor, dict]:
    """The reference's `loss_fn(params, batch, cfg)` over the port's tree:
    batch {"tokens", "labels": (B, S)} -> (loss, {"ce", "aux"}). Gradients
    reach the tree's leaves that are `nn.Parameter`s requiring grad (a
    `train.TrainState`'s); the model is built around them, on their device.

    On a mesh (`layout`): this rank's shards and its batch rows; ce is the
    mean over the global batch (the psum of the ranks' summed NLL over the
    psum of their token counts, over the batch axes), the same on every
    rank, as is the loss."""
    if layout is not None:
        return _mesh_loss_fn(params, batch, cfg, layout)
    model = Transformer(cfg, params, device=params["embed"].device)
    return model.loss_fn(batch["tokens"], batch["labels"])


def lm_local_pspecs(cfg: LMConfig, lr: Optional[LogicalRules]) -> dict:
    """The resolved specs (`param_pspecs`) of the port's tree, one tree a
    layer: each layer leaf's stacked spec without its `stack` entry."""
    stacked = param_pspecs(lm_param_specs(cfg), lr)
    drop = lambda tree: {k: drop(v) if isinstance(v, dict) else tuple(v[1:]) if v else v
                         for k, v in tree.items()}
    return {**stacked, "layers": [drop(stacked["layers"][str(li % cfg.group_size)])
                                  for li in range(cfg.n_layers)]}


# ---------------------------------------------------------------------------
# the model on a mesh
# ---------------------------------------------------------------------------


class MeshLayout:
    """Where the LM's leaves and activations lie on a `ProcessMesh` under
    `rules` (default: `mesh_utils.DEFAULT_RULES`; the reference's training
    step takes `configs.base.LM_TRAIN_RULES`, its decode steps
    `LM_DECODE_RULES` and `LM_LONG_DECODE_RULES`): the resolved spec of
    every leaf of the port's tree (`specs`), the batch axes, this rank's
    place on "model", and the decode cache's `kv_seq` axes with this
    rank's block index along them (row-major over a tuple, as
    `mesh_utils.local_shard` takes it) and their group. Every rank builds
    it alike."""

    def __init__(self, cfg: LMConfig, mesh, rules: Optional[dict] = None):
        self.cfg, self.mesh = cfg, mesh
        self.lr = LogicalRules(mesh, dict(rules or DEFAULT_RULES))
        self.specs = lm_local_pspecs(cfg, self.lr)
        axes = mesh_axes(mesh)
        batch = self.lr._exists(self.lr.rules.get("batch"))
        batch = (batch,) if isinstance(batch, str) else tuple(batch or ())
        self.batch_axes = tuple(a for a in batch if axes[a] > 1)
        # FSDP: a leaf is whole along every axis but "model" where it is used
        # (under LM_LONG_DECODE_RULES the batch is whole, the leaves still
        # split over "data")
        self.gather_axes = tuple(a for a in axes if a != "model" and axes[a] > 1)
        self.n_model = axes.get("model", 1)
        self.m = mesh.axis_index("model") if self.n_model > 1 else 0
        self.g_model = mesh.group("model") if self.n_model > 1 else None
        # the cache's axes as the rules give them (a length every axis divides)
        self.kv_spec = resolve_pspec(("batch", "kv_heads", "kv_seq"),
                                     (math.prod(axes.values()),) * 3, self.lr)
        seq = self.kv_spec[2]
        self.kv_seq_axes = () if seq is None else (seq,) if isinstance(seq, str) else tuple(seq)
        self.n_seq = mesh.axis_size(self.kv_seq_axes) if self.kv_seq_axes else 1
        self.kv_block = mesh.axis_index(self.kv_seq_axes) if self.n_seq > 1 else 0
        self.g_seq = mesh.group(self.kv_seq_axes) if self.n_seq > 1 else None

    def enter_batch(self, w: torch.Tensor, spec) -> torch.Tensor:
        """A leaf entering the batch axes it is not split on (its use
        differs with the rows)."""
        cross = tuple(a for a in self.batch_axes if a not in split_axes(spec))
        return C.enter(w, self.mesh.group(cross)) if cross else w

    def use(self, w: torch.Tensor, spec) -> torch.Tensor:
        """A leaf as this rank uses it, whole along every axis but "model":
        it enters the batch axes it is not split on, and is gathered over
        those it is (FSDP)."""
        return gather(self.enter_batch(w, spec), spec, self.mesh, self.gather_axes)

    def split_on_model(self, spec, dim: int) -> bool:
        return self.n_model > 1 and "model" in spec_layout(spec).get(dim, ())

    def block(self, w: torch.Tensor, spec, dim: int, ranges, parallel: bool) -> torch.Tensor:
        """Slices `ranges` [(lo, hi), ...] of the whole leaf along `dim`,
        concatenated, from w (`use`'s). In a model-parallel block a leaf
        split over "model" gives its own shard or is gathered over "model"
        (the backward sums each rank's share), and a whole leaf enters
        "model"; in a block run alike on every model rank (its inner dim
        whole) every leaf is whole along "model" too, since the specs
        split a block's leaves along the same dims."""
        if self.split_on_model(spec, dim):
            n = w.shape[dim]
            if list(ranges) == [(self.m * n, (self.m + 1) * n)]:
                return w
            if not parallel:
                raise NotImplementedError(f"a leaf split over 'model' ({spec}) in a block "
                                          f"whose inner dim is whole")
            w = C.all_gather(w, self.g_model, dim)
        elif parallel and self.n_model > 1:
            w = C.enter(w, self.g_model)
        if list(ranges) == [(0, w.shape[dim])]:
            return w
        return torch.cat([w.narrow(dim, lo, hi - lo) for lo, hi in ranges], dim)


def _head_plan(cfg: LMConfig, lay: MeshLayout, heads_split: bool):
    """(this rank's first q head, its q head count, its kv heads in the
    order its q heads read them)."""
    H, Hk = cfg.n_heads, cfg.n_kv_heads
    G = H // Hk
    h0, Hl = (lay.m * H // lay.n_model, H // lay.n_model) if heads_split else (0, H)
    if Hl % G == 0:  # whole groups: their kv heads
        kv = list(range(h0 // G, h0 // G + Hl // G))
    elif G % Hl == 0:  # part of one group: its kv head, shared with other ranks
        kv = [h0 // G]
    else:  # neither: one kv head a q head
        kv = [h // G for h in range(h0, h0 + Hl)]
    return h0, Hl, kv


def _col_ranges(heads, Dh: int):
    """Column ranges of consecutive heads."""
    out = []
    for h in heads:
        if out and out[-1][1] == h * Dh:
            out[-1] = (out[-1][0], (h + 1) * Dh)
        else:
            out.append((h * Dh, (h + 1) * Dh))
    return out


def _mesh_attention(p: dict, sp: dict, x: torch.Tensor, cfg: LMConfig, kind: str,
                    positions: torch.Tensor, lay: MeshLayout) -> Tuple[torch.Tensor, dict]:
    B, S, _ = x.shape
    H, Dh = cfg.n_heads, cfg.head_dim
    n, m = lay.n_model, lay.m
    parallel = lay.split_on_model(sp["wo"], 0)  # wo row-parallel: psum over "model"
    heads_split = parallel and resolve_pspec(("heads",), (H,), lay.lr) == ("model",)
    h0, Hl, kv = _head_plan(cfg, lay, heads_split)
    w = {k: lay.use(v, sp[k]) for k, v in p.items()}
    qcols, kvcols = [(h0 * Dh, (h0 + Hl) * Dh)], _col_ranges(kv, Dh)
    x_in = C.enter(x, lay.g_model) if parallel else x
    q = x_in @ lay.block(w["wq"], sp["wq"], 1, qcols, parallel)
    k = x_in @ lay.block(w["wk"], sp["wk"], 1, kvcols, parallel)
    v = x_in @ lay.block(w["wv"], sp["wv"], 1, kvcols, parallel)
    if cfg.qkv_bias:
        q = q + lay.block(w["bq"], sp["bq"], 0, qcols, parallel)
        k = k + lay.block(w["bk"], sp["bk"], 0, kvcols, parallel)
        v = v + lay.block(w["bv"], sp["bv"], 0, kvcols, parallel)
    q, k, v = q.view(B, S, Hl, Dh), k.view(B, S, len(kv), Dh), v.view(B, S, len(kv), Dh)
    if cfg.qk_norm:
        q = L.rms_norm(q, lay.block(w["q_norm"], sp["q_norm"], 0, [(0, Dh)], parallel),
                       cfg.norm_eps)
        k = L.rms_norm(k, lay.block(w["k_norm"], sp["k_norm"], 0, [(0, Dh)], parallel),
                       cfg.norm_eps)
    q = L.rope(q.transpose(1, 2), positions[:, None, :], cfg.rope_theta)
    k = L.rope(k.transpose(1, 2), positions[:, None, :], cfg.rope_theta)
    v = v.transpose(1, 2).contiguous()
    window = cfg.window if kind == "local" else None
    out = ops.attention(q, k, v, causal=True, window=window, softcap=cfg.attn_softcap,
                        allow_chunk=cfg.attn_chunk)
    out = out.transpose(1, 2).reshape(B, S, Hl * Dh)
    if not parallel:
        return out @ lay.block(w["wo"], sp["wo"], 0, [(0, H * Dh)], False), {"k": k, "v": v}
    per = H * Dh // n
    rows = [(m * per, (m + 1) * per)]
    if not heads_split:  # every head here: this rank's rows of wo read their columns
        out = out[..., m * per:(m + 1) * per]
    y = out @ lay.block(w["wo"], sp["wo"], 0, rows, True)
    return C.psum(y, lay.g_model), {"k": k, "v": v}


def _mesh_ffn(p: dict, sp: dict, h: torch.Tensor, cfg: LMConfig,
              lay: MeshLayout) -> Tuple[torch.Tensor, Optional[Routing]]:
    B, S, d = h.shape
    if cfg.moe:
        mc = cfg.moe_cfg()
        want = moe_shard_specs(mc, lay.mesh)
        if sp != want:
            raise NotImplementedError(f"an MoE FFN on a mesh takes moe_ffn_expert_parallel's "
                                      f"in_specs {want}; the rules resolved {sp}")
        local = tree_map_with(lay.enter_batch, p, sp)  # it gathers over "data" itself
        out, r = moe_ffn_expert_parallel(local, h.reshape(B * S, d), mc, lay.mesh)
        return out.view(B, S, d), r
    f = cfg.d_ff
    parallel = lay.split_on_model(sp["w_down"], 0)
    rng = [(lay.m * f // lay.n_model, (lay.m + 1) * f // lay.n_model)] if parallel else [(0, f)]
    w = {k: lay.use(v, sp[k]) for k, v in p.items()}
    h_in = C.enter(h, lay.g_model) if parallel else h
    y = L.swiglu(h_in, lay.block(w["w_gate"], sp["w_gate"], 1, rng, parallel),
                 lay.block(w["w_up"], sp["w_up"], 1, rng, parallel),
                 lay.block(w["w_down"], sp["w_down"], 0, rng, parallel))
    return (C.psum(y, lay.g_model) if parallel else y), None


def _mesh_decode_attention(p: dict, sp: dict, x: torch.Tensor, cfg: LMConfig, kind: str,
                           cache: dict, lay: MeshLayout) -> Tuple[torch.Tensor, dict]:
    """The decode step's attention on a mesh, against this rank's block of
    the cache ({"k", "v": (B_loc, Hkv, S_loc, Dh), "pos"}), which it
    updates in place: (the attention's output, the cache with pos
    advanced)."""
    B, S, _ = x.shape
    H, Hk, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if lay.split_on_model(sp["wk"], 1) or lay.split_on_model(sp["wv"], 1):
        raise NotImplementedError(f"the decode step on a mesh reads every kv head of its "
                                  f"block of positions; the rules split them: {sp['wk']}")
    w = {k: lay.use(v, sp[k]) for k, v in p.items()}
    q, k, v = x @ w["wq"], x @ w["wk"], x @ w["wv"]
    if cfg.qkv_bias:  # bq splits as wq's columns do (both "heads")
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    if lay.split_on_model(sp["wq"], 1):  # every q head: this rank's columns gathered
        q = C.all_gather(q, lay.g_model, 2)
    q, k, v = q.view(B, S, H, Dh), k.view(B, S, Hk, Dh), v.view(B, S, Hk, Dh)
    if cfg.qk_norm:
        q = L.rms_norm(q, w["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, w["k_norm"], cfg.norm_eps)
    pos = cache["pos"]
    positions = (pos + torch.arange(S, device=x.device))[None, :].expand(B, S)
    q = L.rope(q.transpose(1, 2), positions[:, None, :], cfg.rope_theta)  # (B, H, S, Dh)
    k = L.rope(k.transpose(1, 2), positions[:, None, :], cfg.rope_theta)
    v = v.transpose(1, 2)

    ck, cv = cache["k"], cache["v"]
    S_loc = ck.shape[2]
    lo = lay.kv_block * S_loc  # this block's first position
    a, b = max(pos, lo), min(pos + S, lo + S_loc)
    if a < b:  # the owner of the new positions writes them (pos is a host int)
        ck[:, :, a - lo:b - lo] = k[:, :, a - pos:b - pos].to(ck.dtype)
        cv[:, :, a - lo:b - lo] = v[:, :, a - pos:b - pos].to(cv.dtype)
    kpos = lo + torch.arange(S_loc, device=x.device)[None, :]
    qpos = pos + torch.arange(S, device=x.device)[:, None]
    mask = kpos <= qpos
    window = cfg.window if kind == "local" else None
    if window is not None:
        mask &= kpos > qpos - window
    qg = q.reshape(B, Hk, H // Hk, S, Dh)
    logits = L.div(torch.einsum("bhgqd,bhkd->bhgqk", qg, ck).float(), float(np.sqrt(Dh)))
    logits = L.softcap(logits, cfg.attn_softcap)
    logits = torch.where(mask, logits, torch.full((), MASK_VALUE, device=x.device))
    # the softmax over the keys of every block: a wholly masked block's exps are 0
    mx = logits.amax(-1, keepdim=True)
    if lay.g_seq is not None:
        mx = C.pmax(mx, lay.g_seq)
    e = torch.exp(logits - mx)
    total = e.sum(-1, keepdim=True)
    if lay.g_seq is not None:
        total = C.psum(total, lay.g_seq)
    probs = (e / total).to(q.dtype)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, cv)
    if lay.g_seq is not None:  # the partial outputs, summed in float32
        out = C.psum(out.float(), lay.g_seq).to(q.dtype)
    out = out.reshape(B, H, S, Dh).transpose(1, 2).reshape(B, S, H * Dh)
    new_cache = {"k": ck, "v": cv, "pos": pos + S}
    if not lay.split_on_model(sp["wo"], 0):
        return out @ w["wo"], new_cache
    per = H * Dh // lay.n_model  # this rank's rows of wo read their columns
    y = out[..., lay.m * per:(lay.m + 1) * per] @ w["wo"]
    return C.psum(y, lay.g_model), new_cache


def _mesh_layer(p: dict, sp: dict, x: torch.Tensor, cfg: LMConfig, kind: str,
                positions: Optional[torch.Tensor], lay: MeshLayout,
                kv_cache: Optional[dict] = None):
    """`_layer` on a mesh: (x, the MoE `Routing` or None, this rank's KV);
    given this rank's block of a layer's cache, the decode step's layer
    (its positions follow the cache's pos)."""
    n = {k: lay.use(v, sp[k]) for k, v in p.items() if k not in ("attn", "ffn")}
    h = L.rms_norm(x, n["input_norm"], cfg.norm_eps)
    if kv_cache is None:
        attn_out, kv = _mesh_attention(p["attn"], sp["attn"], h, cfg, kind, positions, lay)
    else:
        attn_out, kv = _mesh_decode_attention(p["attn"], sp["attn"], h, cfg, kind, kv_cache,
                                              lay)
    if cfg.post_norms:
        attn_out = L.rms_norm(attn_out, n["post_attn_out_norm"], cfg.norm_eps)
    x = x + attn_out
    h = L.rms_norm(x, n["post_attn_norm"], cfg.norm_eps)
    ffn_out, routing = _mesh_ffn(p["ffn"], sp["ffn"], h, cfg, lay)
    if cfg.post_norms:
        ffn_out = L.rms_norm(ffn_out, n["post_ffn_norm"], cfg.norm_eps)
    return x + ffn_out, routing, kv


def _mesh_group(layers, specs, kinds, x, aux, positions, cfg, lay):
    for p, sp, kind in zip(layers, specs, kinds):
        x, r, _ = _mesh_layer(p, sp, x, cfg, kind, positions, lay)
        if r is not None:
            aux = aux + aux_loss(r)
    return x, aux


def _mesh_embed(params: dict, tokens: torch.Tensor, cfg: LMConfig,
                lay: MeshLayout) -> torch.Tensor:
    """The vocab-parallel lookup: this rank's rows for the ids it owns, 0
    for the others, psum'd over "model"."""
    sp = lay.specs["embed"]
    emb = lay.use(params["embed"], sp)
    if lay.split_on_model(sp, 0):
        v_loc = emb.shape[0]
        ids = tokens.long() - lay.m * v_loc
        mine = (ids >= 0) & (ids < v_loc)
        x = F.embedding(ids.clamp(0, v_loc - 1), emb)
        x = C.psum(torch.where(mine[..., None], x, torch.zeros((), dtype=x.dtype,
                                                                  device=x.device)), lay.g_model)
    else:
        x = F.embedding(tokens.long(), emb)
    x = x.to(cfg.dtype)
    if cfg.embed_scale:
        s = torch.tensor(np.sqrt(cfg.d_model).astype(np.float32), device=x.device)
        x = x * s.to(cfg.dtype)
    return x


def trunk(params: dict, tokens: torch.Tensor, cfg: LMConfig,
          layout: MeshLayout) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's `trunk` on a mesh, differentiable: this rank's shards
    `params` and its batch rows tokens (B_loc, S) -> (x (B_loc, S, d) after
    the final norm, the same on every model rank; aux, the MoE layers'
    load-balance losses summed, each averaged over the batch axes). Each
    layer group runs under `torch.utils.checkpoint` when `cfg.remat`: its
    backward gathers its weights again."""
    lay = layout
    B, S = tokens.shape
    x = _mesh_embed(params, tokens, cfg, lay)
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    aux = torch.zeros((), device=x.device)
    G = cfg.group_size
    for g in range(cfg.n_groups):
        sl = slice(g * G, (g + 1) * G)
        args = (params["layers"][sl], lay.specs["layers"][sl], cfg.pattern, x, aux, positions,
                cfg, lay)
        if cfg.remat:
            x, aux = checkpoint(_mesh_group, *args, use_reentrant=False)
        else:
            x, aux = _mesh_group(*args)
    fn = lay.use(params["final_norm"], lay.specs["final_norm"])
    return L.rms_norm(x, fn, cfg.norm_eps), aux


def _unembed(params: dict, lay: MeshLayout):
    """(this rank's unembed columns, whole along the batch axes; the first
    vocab id among them; whether the vocab is split over "model")."""
    sp = lay.specs["unembed"]
    u = lay.use(params["unembed"], sp)
    split = lay.split_on_model(sp, 1)
    return u, (lay.m * u.shape[1] if split else 0), split


def _mesh_loss_fn(params: dict, batch: dict, cfg: LMConfig,
                  lay: MeshLayout) -> Tuple[torch.Tensor, dict]:
    x, aux = trunk(params, batch["tokens"], cfg, lay)
    u, lo, split = _unembed(params, lay)
    if split:
        x = C.enter(x, lay.g_model)
    nll = L.chunked_unembed_xent(x, u, batch["labels"], cap=cfg.final_softcap,
                                 chunk=cfg.xent_chunk, group=lay.g_model if split else None,
                                 vocab_lo=lo, mean=False)
    count = torch.full((), float(batch["labels"].numel()), device=nll.device)
    if lay.batch_axes:
        g = lay.mesh.group(lay.batch_axes)
        nll, count = C.psum(nll, g), C.psum(count, g)
    ce = nll / count
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


@torch.no_grad()
def prefill_forward(params: dict, tokens: torch.Tensor, cfg: LMConfig,
                    layout: MeshLayout) -> Tuple[torch.Tensor, dict]:
    """The reference's `prefill_forward` on a mesh: this rank's shards and
    its batch rows tokens (B_loc, S) -> (its block of the last position's
    float32 logits, (B_loc, V_loc) where the vocab splits over "model";
    the KV stack of the heads it computed, {pattern index: {"k", "v":
    (n_groups, B_loc, its kv heads, S, Dh)}})."""
    lay = layout
    B, S = tokens.shape
    x = _mesh_embed(params, tokens, cfg, lay)
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    kvs = []
    for li, (p, sp) in enumerate(zip(params["layers"], lay.specs["layers"])):
        x, _, kv = _mesh_layer(p, sp, x, cfg, cfg.pattern[li % cfg.group_size], positions, lay)
        kvs.append(kv)
    x = L.rms_norm(x, lay.use(params["final_norm"], lay.specs["final_norm"]), cfg.norm_eps)
    u, _, _ = _unembed(params, lay)
    logits = L.softcap((x[:, -1:, :] @ u).float(), cfg.final_softcap)[:, 0]
    G = cfg.group_size
    stack = {str(i): {n: torch.stack([kv[n] for kv in kvs[i::G]]) for n in ("k", "v")}
             for i in range(G)}
    return logits, stack


@torch.no_grad()
def serve_step(params: dict, kv_cache: dict, tokens: torch.Tensor, cfg: LMConfig,
               layout: MeshLayout) -> Tuple[torch.Tensor, dict]:
    """The reference's `serve_step` on a mesh (`layout`, under
    `LM_DECODE_RULES` or `LM_LONG_DECODE_RULES`), one decode step: this
    rank's shards of the parameters (`models.param.local_params`), its
    block of the cache (`local_kv_cache`) and its rows tokens (B_loc, S) new
    ids -> (its block of the last position's float32 logits, (B_loc, V_loc)
    where the vocab splits over "model"; its block of the cache updated in
    place, pos advanced by S)."""
    lay = layout
    x = _mesh_embed(params, tokens, cfg, lay)
    new_layers = []
    for li, (p, sp, cache) in enumerate(zip(params["layers"], lay.specs["layers"],
                                            kv_cache["layers"])):
        x, _, new_cache = _mesh_layer(p, sp, x, cfg, cfg.pattern[li % cfg.group_size], None,
                                      lay, kv_cache=cache)
        new_layers.append(new_cache)
    x = L.rms_norm(x, lay.use(params["final_norm"], lay.specs["final_norm"]), cfg.norm_eps)
    u, _, _ = _unembed(params, lay)
    return L.softcap((x[:, -1:, :] @ u).float(), cfg.final_softcap)[:, 0], {"layers": new_layers}


# ---------------------------------------------------------------------------
# one layer
# ---------------------------------------------------------------------------


def _attention(p: nn.ParameterDict, x: torch.Tensor, cfg: LMConfig, kind: str,
               positions: torch.Tensor,
               kv_cache: Optional[dict] = None) -> Tuple[torch.Tensor, dict]:
    B, S, _ = x.shape
    H, Hk, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q, k, v = q.view(B, S, H, Dh), k.view(B, S, Hk, Dh), v.view(B, S, Hk, Dh)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = L.rope(q.transpose(1, 2), positions[:, None, :], cfg.rope_theta)  # (B,H,S,Dh)
    k = L.rope(k.transpose(1, 2), positions[:, None, :], cfg.rope_theta)
    v = v.transpose(1, 2).contiguous()

    window = cfg.window if kind == "local" else None
    if kv_cache is None:
        out = ops.attention(q, k, v, causal=True, window=window, softcap=cfg.attn_softcap,
                            allow_chunk=cfg.attn_chunk)
        new_cache = {"k": k, "v": v}
    else:
        pos = kv_cache["pos"]
        ck, cv = kv_cache["k"], kv_cache["v"]
        ck[:, :, pos:pos + S] = k.to(ck.dtype)
        cv[:, :, pos:pos + S] = v.to(cv.dtype)
        kpos = torch.arange(ck.shape[2], device=x.device)[None, :]
        qpos = pos + torch.arange(S, device=x.device)[:, None]
        mask = kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        # q head h reads kv head h // (H / Hk): group the q heads, no repeat
        qg = q.reshape(B, Hk, H // Hk, S, Dh)
        logits = L.div(torch.einsum("bhgqd,bhkd->bhgqk", qg, ck).float(), float(np.sqrt(Dh)))
        logits = L.softcap(logits, cfg.attn_softcap)
        logits = torch.where(mask, logits, torch.full((), MASK_VALUE, device=x.device))
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhgqk,bhkd->bhgqd", probs.to(q.dtype), cv).reshape(B, H, S, Dh)
        new_cache = {"k": ck, "v": cv, "pos": pos + S}
    out = out.transpose(1, 2).reshape(B, S, H * Dh)
    return out @ p["wo"], new_cache


def _layer(lp: Layer, x: torch.Tensor, cfg: LMConfig, positions: torch.Tensor,
           kv_cache: Optional[dict] = None
           ) -> Tuple[torch.Tensor, Optional[Routing], dict]:
    """One layer: (x, the MoE FFN's `Routing` (None for a dense FFN), the KV)."""
    n = lp.norms
    h = L.rms_norm(x, n["input_norm"], cfg.norm_eps)
    attn_out, new_cache = _attention(lp.attn, h, cfg, lp.kind, positions, kv_cache)
    if cfg.post_norms:
        attn_out = L.rms_norm(attn_out, n["post_attn_out_norm"], cfg.norm_eps)
    x = x + attn_out
    h = L.rms_norm(x, n["post_attn_norm"], cfg.norm_eps)
    if cfg.moe:  # tokens flattened row-major: capacity ranks favour earlier rows
        B, S, d = h.shape
        ffn_out, routing = lp.ffn(h.reshape(B * S, d))
        ffn_out = ffn_out.view(B, S, d)
    else:
        ffn_out = L.swiglu(h, lp.ffn["w_gate"], lp.ffn["w_up"], lp.ffn["w_down"])
        routing = None
    if cfg.post_norms:
        ffn_out = L.rms_norm(ffn_out, n["post_ffn_norm"], cfg.norm_eps)
    return x + ffn_out, routing, new_cache
