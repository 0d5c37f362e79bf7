"""Decoupled graph storage tier.

The paper's storage tier is RAMCloud: adjacency lists keyed by node id,
hash-partitioned across storage servers, read with a batched `multi_read`.
Here the rows of every shard live in device memory, re-indexed by shard:
shard s holds the rows r with owner(r) == s in local slot order; `loc`
maps a global row id to its slot, `owner` to its shard. Continuation rows
are placed like ordinary rows (their ids are >= n).

`multi_read_ref` is the single-device read: a gather through the
placement tables. The sharded all_to_all read is later work.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graph.csr import PaddedAdjacency
from repro_torch.graph.partition import splitmix64


@dataclasses.dataclass
class StorageTier:
    """Padded adjacency + hash placement, on one device."""

    n_shards: int
    rows_per_shard: int
    shard_rows: torch.Tensor  # (S, rows_per_shard, W) int32
    shard_deg: torch.Tensor  # (S, rows_per_shard) int32
    shard_cont: torch.Tensor  # (S, rows_per_shard) int32
    owner: torch.Tensor  # (n_rows,) int32
    loc: torch.Tensor  # (n_rows,) int32
    n: int  # real nodes
    n_rows: int  # incl. continuation rows

    @property
    def row_width(self) -> int:
        return int(self.shard_rows.shape[2])

    @property
    def device(self) -> torch.device:
        return self.shard_rows.device


def build_storage(adj: PaddedAdjacency, n_shards: int, seed: int = 0,
                  device: DeviceLike = None) -> StorageTier:
    """Hash-place the rows of `adj` over `n_shards` shards (host-side
    placement, then one copy to the device)."""
    dev = resolve_device(device)
    n_rows = adj.n_rows
    h = splitmix64(np.arange(n_rows, dtype=np.uint64) + np.uint64(seed * 1315423911))
    owner = (h % np.uint64(n_shards)).astype(np.int32)
    loc = np.zeros(n_rows, dtype=np.int32)
    counts = np.zeros(n_shards, dtype=np.int64)
    order = np.argsort(owner, kind="stable")
    for s in range(n_shards):  # local slot = rank within shard
        ids = order[owner[order] == s]
        loc[ids] = np.arange(ids.size, dtype=np.int32)
        counts[s] = ids.size
    rows_per_shard = int(counts.max()) if n_rows else 1
    shard_rows = np.full((n_shards, rows_per_shard, adj.max_degree), -1, dtype=np.int32)
    shard_deg = np.zeros((n_shards, rows_per_shard), dtype=np.int32)
    shard_cont = np.full((n_shards, rows_per_shard), -1, dtype=np.int32)
    shard_rows[owner, loc] = adj.rows
    shard_deg[owner, loc] = adj.degree
    shard_cont[owner, loc] = adj.cont
    return StorageTier(
        n_shards=n_shards,
        rows_per_shard=rows_per_shard,
        shard_rows=torch.from_numpy(shard_rows).to(dev),
        shard_deg=torch.from_numpy(shard_deg).to(dev),
        shard_cont=torch.from_numpy(shard_cont).to(dev),
        owner=torch.from_numpy(owner).to(dev),
        loc=torch.from_numpy(loc).to(dev),
        n=adj.n,
        n_rows=n_rows,
    )


def multi_read_ref(
    tier: StorageTier, ids: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-device multi_read. ids: (B,) int32 row ids (-1 = no-op).
    Returns (rows (B, W), deg (B,), cont (B,))."""
    safe = ids.clamp(min=0).long()
    o, l = tier.owner[safe].long(), tier.loc[safe].long()
    invalid = ids < 0
    return (
        torch.where(invalid[:, None], -1, tier.shard_rows[o, l]),
        torch.where(invalid, 0, tier.shard_deg[o, l]),
        torch.where(invalid, -1, tier.shard_cont[o, l]),
    )
