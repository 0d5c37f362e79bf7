"""Carry state across between the reference package and the port.

Objects of the reference package are read field by field with
`np.asarray` (which needs no import of its framework), and built into the
port's types on a device. The reverse direction returns numpy arrays, so
that the two packages' results can be compared as numpy.

Packed visited words are uint32 in the reference and int32 with the same
bits here: they cross as a bit-for-bit view, never a value cast.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.cache import CacheState
from repro_torch.core.dispatch import BacklogState
from repro_torch.core.embedding import EmbedConfig, GraphEmbedding
from repro_torch.core.landmarks import LandmarkIndex
from repro_torch.core.router import RouterState
from repro_torch.core.storage import StorageTier
from repro_torch.device import DeviceLike, resolve_device


def tensor(x, device: DeviceLike = None) -> torch.Tensor:
    """Any array-like (numpy, or an array of the reference package) -> tensor."""
    return torch.from_numpy(np.array(np.asarray(x))).to(resolve_device(device))


def words_to_torch(words, device: DeviceLike = None) -> torch.Tensor:
    """uint32 packed words -> int32 tensor with the same bits."""
    a = np.ascontiguousarray(np.asarray(words, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(resolve_device(device))


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """int32 packed words -> uint32 numpy with the same bits."""
    return words.detach().cpu().numpy().view(np.uint32)


def to_numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


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
