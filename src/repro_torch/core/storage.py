"""Decoupled graph storage tier.

The paper's storage tier is RAMCloud: adjacency lists keyed by node id,
hash-partitioned across storage servers, read with a batched `multi_read`.
Here the rows of every shard live in device memory, re-indexed by shard:
shard s holds the rows r with owner(r) == s in local slot order; `loc`
maps a global row id to its slot, `owner` to its shard. Continuation rows
are placed like ordinary rows (their ids are >= n).

`multi_read_ref` is the single-device read: a gather through the
placement tables. `sharded_multi_read` is the distributed one, RAMCloud's
multi_read dataflow over the storage group of a process mesh: bucket the
requests by owner, `all_to_all` them, gather from the local shard,
`all_to_all` the rows back. `make_serving_storage` gives a rank its shard.
`sharded_feature_gather` runs the same dataflow with a float payload over
rows striped by `stripe_rows`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import collectives
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


# ---------------------------------------------------------------------------
# Distributed multi_read: one rank's side of the storage group's exchange
# ---------------------------------------------------------------------------


def bucket_by_owner(
    ids: torch.Tensor, owners: torch.Tensor, n_shards: int, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack request ids into an (n_shards, capacity) matrix bucketed by owner.

    Returns (buckets (S, C) int32 padded -1, slot (B,) int32: the position
    of each request inside its bucket, or -1 where the request is invalid
    or over `capacity`). Positions follow the order of appearance (a stable
    sort by owner). An owner outside [0, S) is taken modulo S when it is in
    [-S, 0) and dropped from the buckets otherwise, as the reference's
    scatter does; its slot still reads its position.
    """
    B = ids.shape[0]
    dev = ids.device
    valid = ids >= 0
    owners_v = torch.where(valid, owners, n_shards)  # invalid -> past every shard
    sorted_owners, order = torch.sort(owners_v, stable=True)
    first = torch.searchsorted(sorted_owners, sorted_owners, side="left")
    pos = torch.empty(B, dtype=torch.int64, device=dev)
    pos[order] = torch.arange(B, device=dev) - first
    keep = valid & (pos < capacity)
    slot = torch.where(keep, pos, -1).to(torch.int32)
    row = torch.where(owners < 0, owners + n_shards, owners).long()
    write = keep & (row >= 0) & (row < n_shards)
    # what is not written lands in an overflow row, cut off below: never
    # in slot (0, 0)
    buckets = torch.full((n_shards + 1, capacity), -1, dtype=torch.int32, device=dev)
    buckets[torch.where(write, row, n_shards), torch.where(write, pos, 0)] = \
        torch.where(write, ids, -1).to(torch.int32)
    return buckets[:n_shards], slot


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    """Row s of `x` (S, ...) goes to the group's rank s; row s of the
    result came from it (the reference's tiled all_to_all over axis 0). A
    float payload's gradient goes back to the rank that sent the row."""
    return collectives.all_to_all(x, group)


def sharded_multi_read(
    ids: torch.Tensor,
    local_rows: torch.Tensor,
    local_deg: torch.Tensor,
    local_cont: torch.Tensor,
    owner_lut: torch.Tensor,
    loc_lut: torch.Tensor,
    group,
    n_shards: int,
    capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """RAMCloud multi_read over the storage group. Every rank of `group`
    calls it at once; its rank s in the group holds shard s.

    ids: (B,) int32 this processor's requests (-1 padded). local_*: this
    rank's shard (rows_per_shard, ...). owner_lut / loc_lut: (n_rows,)
    replicated placement tables. capacity: the per-(requester, shard)
    request budget of the exchange.

    Returns (rows (B, W), deg (B,), cont (B,), served (B,) bool). Requests
    over `capacity` have served=False and must be retried. The rows, deg
    and cont go back as one int32 payload (S, C, W + 2).
    """
    W = local_rows.shape[1]
    owners = torch.where(ids >= 0, owner_lut[ids.clamp(min=0).long()], 0)
    buckets, slot = bucket_by_owner(ids, owners, n_shards, capacity)
    # row j of req: the requests group rank j addressed to this shard
    req = _exchange(buckets, group)
    loc = loc_lut[req.clamp(min=0).long()].long()
    inval = req < 0
    payload = torch.cat([
        torch.where(inval[..., None], -1, local_rows[loc]),
        torch.where(inval, 0, local_deg[loc])[..., None],
        torch.where(inval, -1, local_cont[loc])[..., None],
    ], dim=-1)
    back = _exchange(payload, group)  # (S, C, W + 2): our requests' bucket layout
    served = slot >= 0
    got = back[torch.where(served, owners, 0).long(), torch.where(served, slot, 0).long()]
    return (
        torch.where(served[:, None], got[:, :W], -1),
        torch.where(served, got[:, W], 0),
        torch.where(served, got[:, W + 1], -1),
        served,
    )


def sharded_feature_gather(
    ids: torch.Tensor, local_feat: torch.Tensor, group, n_shards: int, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """multi_read with a float payload: feature rows fetched by global id
    from the shards that own them. Placement is analytic (`stripe_rows`):
    owner(r) = r % n_shards, local slot r // n_shards.

    ids: (M,) int32 (-1 padded); local_feat: (rows_per_shard, F) this
    rank's rows. Returns (features (M, F), served (M,) bool).
    Differentiable in local_feat: a fetched row's gradient goes back to the
    rank that owns it (the reverse exchange), as the reference's all_to_all
    transposes."""
    valid = ids >= 0
    owners = torch.where(valid, ids % n_shards, 0).to(torch.int32)
    buckets, slot = bucket_by_owner(ids, owners, n_shards, capacity)
    req = _exchange(buckets, group)
    g = local_feat[torch.where(req >= 0, req // n_shards, 0).long()]  # (S, C, F)
    back = _exchange(torch.where((req >= 0)[..., None], g, 0), group)
    served = slot >= 0
    out = back[torch.where(served, owners, 0).long(), torch.where(served, slot, 0).long()]
    return torch.where(served[:, None], out, 0), served


def stripe_rows(x: np.ndarray, n_shards: int) -> np.ndarray:
    """Host-side layout for `sharded_feature_gather`: row r goes to shard
    r % n_shards, local slot r // n_shards. Returns the
    (n_shards * rows_per_shard, F) array, shard-major: shard s's rows are
    the s-th block of rows_per_shard."""
    n, f = x.shape
    rows_per_shard = -(-n // n_shards)
    out = np.zeros((n_shards, rows_per_shard, f), x.dtype)
    r = np.arange(n)
    out[r % n_shards, r // n_shards] = x
    return out.reshape(n_shards * rows_per_shard, f)


def make_serving_storage(tier: StorageTier, shard: int, device: DeviceLike = None) -> dict:
    """A rank's storage for the distributed path, on `device`: its own
    shard's rows / deg / cont (rows_per_shard, ...) and the replicated
    owner / loc placement tables (n_rows,)."""
    dev = resolve_device(device)
    return {
        "rows": tier.shard_rows[shard].to(dev),
        "deg": tier.shard_deg[shard].to(dev),
        "cont": tier.shard_cont[shard].to(dev),
        "owner": tier.owner.to(dev),
        "loc": tier.loc.to(dev),
    }
