"""Decoder-only LM: prefill and decode (the reference's
`models/transformer.py`).

Per-architecture flags in `LMConfig`: GQA, QKV bias (qwen2.5), per-head qk
RMS norm (qwen3), alternating local (sliding-window) / global layers,
attention and final logit softcaps, post-norms and embedding scaling
(gemma2), MoE FFNs with a shared expert (qwen2-moe) or without (dbrx):
`n_experts > 0`, `models/moe.py`. The loss heads and training wait for
later slices.

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
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import MASK_VALUE
from repro_torch.models import layers as L
from repro_torch.models.moe import MoE, MoEConfig, Routing, aux_loss, moe_param_specs
from repro_torch.models.param import ParamSpec, init_params, tree_map


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


def _param(x: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(x, requires_grad=False)


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
