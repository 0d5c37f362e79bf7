"""Carry state across between the reference package and the port.

Objects of the reference package are read field by field with
`np.asarray` (which needs no import of its framework), and built into the
port's types on a device. The reverse direction returns numpy arrays, so
that the two packages' results can be compared as numpy.

Packed visited words are uint32 in the reference and int32 with the same
bits here: they cross as a bit-for-bit view, never a value cast. bfloat16
arrays (numpy has no bfloat16 of its own) cross the same way, as their
uint16 bits.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.cache import CacheState
from repro_torch.core.dispatch import BacklogState
from repro_torch.core.embedding import EmbedConfig, GraphEmbedding
from repro_torch.core.landmarks import LandmarkIndex
from repro_torch.core.router import RouterState
from repro_torch.core.storage import StorageTier
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.param import tree_map
from repro_torch.models.transformer import LMConfig, stack_layers, unstack_layers
from repro_torch.train.train_step import TrainState, trainable


def tensor(x, device: DeviceLike = None) -> torch.Tensor:
    """Any array-like (numpy, or an array of the reference package) -> tensor;
    bfloat16 crosses bit for bit, as its uint16 bits."""
    a = np.array(np.asarray(x))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            .to(resolve_device(device))
    return torch.from_numpy(a).to(resolve_device(device))


def words_to_torch(words, device: DeviceLike = None) -> torch.Tensor:
    """uint32 packed words -> int32 tensor with the same bits."""
    a = np.ascontiguousarray(np.asarray(words, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(resolve_device(device))


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """int32 packed words -> uint32 numpy with the same bits."""
    return words.detach().cpu().numpy().view(np.uint32)


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy; a bfloat16 tensor comes back as its uint16 bits
    (view them as the reference's bfloat16 to compare)."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def storage_tier(tier, device: DeviceLike = None) -> StorageTier:
    return StorageTier(
        n_shards=int(tier.n_shards),
        rows_per_shard=int(tier.rows_per_shard),
        shard_rows=tensor(tier.shard_rows, device),
        shard_deg=tensor(tier.shard_deg, device),
        shard_cont=tensor(tier.shard_cont, device),
        owner=tensor(tier.owner, device),
        loc=tensor(tier.loc, device),
        n=int(tier.n),
        n_rows=int(tier.n_rows),
    )


def cache_state(state, device: DeviceLike = None) -> CacheState:
    """A (possibly (P,)-stacked) reference CacheState -> the port's."""
    return CacheState(**{f.name: tensor(getattr(state, f.name), device)
                         for f in dataclasses.fields(CacheState)})


def processor_cache(caches: dict, proc: int, device: DeviceLike = None) -> CacheState:
    """Processor `proc`'s slice of the reference's stacked caches (the
    dict of (n_proc, ...) leaves that its `make_processor_caches` and
    serve step give)."""
    return CacheState(**{f.name: tensor(np.asarray(caches[f.name])[proc], device)
                         for f in dataclasses.fields(CacheState)})


def serve_inputs(inputs: dict, proc: int, shard: int, device: DeviceLike = None) -> dict:
    """One rank's inputs of the distributed serve step from the reference's
    (whole-mesh) inputs dict: processor `proc`'s queries and cache, storage
    shard `shard` of `make_serving_storage`'s rows / deg / cont, and the
    replicated placement tables, coordinates and EMA. Keys absent from
    `inputs` are left out."""
    per_proc = {"queries": lambda a: a[proc], "rows": lambda a: a[shard],
                "deg": lambda a: a[shard], "cont": lambda a: a[shard]}
    out = {k: tensor(per_proc.get(k, lambda a: a)(np.asarray(v)), device)
           for k, v in inputs.items() if k != "cache"}
    if "cache" in inputs:
        out["cache"] = processor_cache(inputs["cache"], proc, device)
    return out


def router_state(state, device: DeviceLike = None) -> RouterState:
    return RouterState(load=tensor(state.load, device), ema=tensor(state.ema, device),
                       rr=tensor(state.rr, device))


def backlog_state(state, device: DeviceLike = None) -> BacklogState:
    return BacklogState(qid=tensor(state.qid, device), node=tensor(state.node, device))


def landmark_index(index) -> LandmarkIndex:
    return LandmarkIndex(**{f.name: np.array(np.asarray(getattr(index, f.name)))
                            for f in dataclasses.fields(LandmarkIndex)})


def graph_embedding(emb) -> GraphEmbedding:
    cfg = EmbedConfig(**{f.name: getattr(emb.config, f.name)
                         for f in dataclasses.fields(EmbedConfig)})
    return GraphEmbedding(coords=np.array(np.asarray(emb.coords), dtype=np.float32),
                          landmarks=np.array(np.asarray(emb.landmarks)),
                          lm_coords=np.array(np.asarray(emb.lm_coords)),
                          config=cfg)


def fields_to_numpy(obj) -> dict:
    """A port dataclass or NamedTuple -> {field: numpy array or value}: the
    reverse direction, for comparing with the reference's objects."""
    items = obj._asdict().items() if hasattr(obj, "_asdict") else \
        ((f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj))
    return {k: to_numpy(v) if isinstance(v, torch.Tensor) else v for k, v in items}


# ---------------------------------------------------------------------------
# LM parameters and configurations
# ---------------------------------------------------------------------------


def lm_config_from_reference(cfg) -> LMConfig:
    """The reference's LMConfig -> the port's: the fields the port has, the
    dtype by name. Training-only fields are dropped."""
    names = {f.name for f in dataclasses.fields(LMConfig)}
    kw = {k: getattr(cfg, k) for k in names if k != "dtype"}
    return LMConfig(**kw, dtype=getattr(torch, np.dtype(cfg.dtype).name))


def lm_params_from_reference(params, cfg: LMConfig, device: DeviceLike = None) -> dict:
    """The reference's LM parameter tree (stacked per pattern index) -> the
    port's (one tree per layer: layer li is group li // len(pattern) at
    pattern index li % len(pattern)), for `Transformer(cfg, params)`."""
    return unstack_layers(tree_map(lambda a: tensor(a, device), params), cfg)


def lm_params_to_reference(params: dict, cfg: LMConfig) -> dict:
    """The port's tree -> the reference's stacked layout as numpy (bfloat16
    leaves as uint16 bits): the inverse of `lm_params_from_reference`."""
    return tree_map(to_numpy, stack_layers(params, cfg))


# ---------------------------------------------------------------------------
# parameter trees and training state
# ---------------------------------------------------------------------------


def params_from_reference(tree, device: DeviceLike = None):
    """A reference parameter tree of dicts and lists (the GNN and recsys
    zoo's, or any tree without stacked layers) -> the same tree of tensors
    on `device`, leaf by leaf."""
    return tree_map(lambda a: tensor(a, device), tree)


def params_to_reference(tree):
    """The port's tree -> the same tree of numpy arrays (bfloat16 leaves as
    uint16 bits): the inverse of `params_from_reference`."""
    return tree_map(to_numpy, tree)



def train_state_from_reference(state, cfg: Optional[LMConfig] = None,
                               device: DeviceLike = None) -> TrainState:
    """The reference's `TrainState` -> the port's: params, m and v through
    `lm_params_from_reference` (leaf by leaf when cfg is None, for a tree
    without stacked layers), the parameters made trainable; count and step."""
    def conv(tree):
        if cfg is not None:
            return lm_params_from_reference(tree, cfg, device)
        return params_from_reference(tree, device)

    opt = state.opt_state
    return TrainState(params=trainable(conv(state.params)),
                      opt_state={"m": conv(opt["m"]), "v": conv(opt["v"]),
                                 "count": tensor(opt["count"], device)},
                      step=tensor(state.step, device))


def train_state_to_reference(state: TrainState, cfg: Optional[LMConfig] = None) -> dict:
    """The port's `TrainState` -> {"params", "opt_state": {"m", "v", "count"},
    "step"} as numpy in the reference's layout (stacked when cfg is given;
    bfloat16 leaves as uint16 bits): the inverse of
    `train_state_from_reference`."""
    def conv(tree):
        if cfg is not None:
            return lm_params_to_reference(tree, cfg)
        return params_to_reference(tree)

    opt = state.opt_state
    return {"params": conv(state.params),
            "opt_state": {"m": conv(opt["m"]), "v": conv(opt["v"]),
                          "count": to_numpy(opt["count"])},
            "step": to_numpy(state.step)}
